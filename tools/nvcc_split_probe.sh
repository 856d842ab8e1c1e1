#!/bin/bash
# Build each CUDA source in src/repro_torch/csrc twice on the card's
# machine, with the kernel build's flags and with them plus
# --split-compile=0, print both wall times, and compare the two libraries'
# SASS: per function, whether the text is identical, and over the file
# the count of every floating-point opcode (equal counts: the same
# arithmetic).  Run from the repository root:
#     bash tools/nvcc_split_probe.sh [OUT_DIR]     (default build/split_probe)
set -u
NVCC=${NVCC:-/usr/local/cuda/bin/nvcc}
CUOBJDUMP=${CUOBJDUMP:-/usr/local/cuda/bin/cuobjdump}
OUT=${1:-build/split_probe}
mkdir -p "$OUT"
echo "cores $(nproc); $($NVCC --version | tail -1)"
FLAGS="-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC"
for src in redmule_matmul flash_attention chunked_linear_attention; do
  for v in base split; do
    extra=""; [ "$v" = split ] && extra="--split-compile=0"
    s=$(date +%s.%N)
    $NVCC $FLAGS $extra -o "$OUT/$src.$v.so" "src/repro_torch/csrc/$src.cu" > "$OUT/$src.$v.log" 2>&1
    rc=$?; e=$(date +%s.%N)
    python3 -c "print('$src $v: exit $rc, %.1f s' % ($e - $s))"
    $CUOBJDUMP -sass "$OUT/$src.$v.so" > "$OUT/$src.$v.sass"
  done
  python3 - "$OUT/$src.base.sass" "$OUT/$src.split.sass" "$src" <<'PY'
import collections, re, sys

def funcs(path):
    out, cur = {}, None
    for line in open(path):
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            out[cur] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if m and cur:
            out[cur].append(re.sub(r"\s+", " ", m.group(1)).strip())
    return out

def opcodes(lines):
    return collections.Counter(re.sub(r"^@!?U?P\w+ ", "", i).split(" ")[0] for i in lines)

a, b, name = funcs(sys.argv[1]), funcs(sys.argv[2]), sys.argv[3]
same = [k for k in a if b.get(k) == a[k]]
fp = ("FFMA", "FMUL", "FADD", "HFMA2", "HMUL2", "HADD2", "HMMA", "F2F", "F2FP", "MUFU")
ta, tb = collections.Counter(), collections.Counter()
for k in a:
    ta.update(opcodes(a[k]))
for k in b:
    tb.update(opcodes(b[k]))
fa = {o: n for o, n in ta.items() if o.startswith(fp)}
fb = {o: n for o, n in tb.items() if o.startswith(fp)}
print(f"{name}: {len(a)} / {len(b)} functions, {len(same)} with identical SASS; "
      f"floating-point opcode counts equal: {fa == fb}")
for k in sorted(set(a) - set(same)):
    d = {o: (n, opcodes(b.get(k, [])).get(o, 0)) for o, n in opcodes(a[k]).items()
         if n != opcodes(b.get(k, [])).get(o, 0)}
    print(f"  differs: {k[:100]} ({len(a[k])} / {len(b.get(k, []))} instructions): "
          f"{dict(sorted(d.items())[:10])}")
PY
done
