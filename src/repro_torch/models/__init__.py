"""Model composition on the engine (dense GQA decoder LMs)."""
