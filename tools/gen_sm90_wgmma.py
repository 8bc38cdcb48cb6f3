"""Write ``cara_tpu_torch/csrc/sm90_wgmma.cuh``: the bf16 ``wgmma`` wrappers
(m64nNk16, fp32 accumulators) for the widths the Hopper attention kernels
use, A from shared memory (``wgmma_ss``) or from registers
(``wgmma_rs``).  The PTX lists every accumulator register, so the wrappers
are generated rather than written by hand.

    python tools/gen_sm90_wgmma.py
"""

from pathlib import Path

OUT = (Path(__file__).resolve().parents[1] / "cara_tpu_torch" / "csrc"
       / "sm90_wgmma.cuh")
WIDTHS = (16, 32, 64, 128, 200, 256)

HEAD = """\
// Generated by tools/gen_sm90_wgmma.py; do not edit.
//
// bf16 wgmma.m64nNk16 with fp32 accumulators d[N / 2] (the accumulator
// layout of PTX's wgmma: d[4j + c] holds row w * 16 + lane / 4 + 8 (c / 2),
// column 8j + 2 (lane % 4) + c % 2 for warp w of the warpgroup).
//   wgmma_ss<N, TA, TB>(d, desc_a, desc_b, scale_d): A and B in shared
//     memory, by descriptor; TA / TB = 1 read that operand MN-major.
//   wgmma_rs<N, TB>(d, a, desc_b, scale_d): A from four bf16x2 registers
//     (the mma.sync m16n8k16 A fragment of the warp's 16 rows).
// scale_d = 0 overwrites d, 1 accumulates.

#pragma once

#include <stdint.h>

namespace sm90 {

template <int N, int TA, int TB>
struct WgmmaSS;
template <int N, int TB>
struct WgmmaRS;
"""

TAIL = """
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  WgmmaSS<N, TA, TB>::run(d, da, db, scale_d);
}

template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  WgmmaRS<N, TB>::run(d, a, db, scale_d);
}

}  // namespace sm90
"""


def _regs(n: int) -> tuple[str, str]:
    k = n // 2
    names = ", ".join(f"%{i}" for i in range(k))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(k))
    return "{" + names + "}", outs


def _ss(n: int) -> str:
    k = n // 2
    names, outs = _regs(n)
    return f"""
template <int TA, int TB>
struct WgmmaSS<{n}, TA, TB> {{
  static __device__ __forceinline__ void run(float (&d)[{k}], uint64_t da,
                                             uint64_t db, int scale_d) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{k + 2}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
        "{names}, %{k}, %{k + 1}, p, 1, 1, %{k + 3}, %{k + 4};\\n}}\\n"
        : {outs}
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }}
}};
"""


def _rs(n: int) -> str:
    k = n // 2
    names, outs = _regs(n)
    return f"""
template <int TB>
struct WgmmaRS<{n}, TB> {{
  static __device__ __forceinline__ void run(float (&d)[{k}],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{k + 5}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
        "{names}, {{%{k}, %{k + 1}, %{k + 2}, %{k + 3}}}, %{k + 4}, p, 1, "
        "1, %{k + 6};\\n}}\\n"
        : {outs}
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d), "n"(TB));
  }}
}};
"""


def main() -> None:
    body = "".join(_ss(n) + _rs(n) for n in WIDTHS)
    OUT.write_text(HEAD + body + TAIL)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
