"""Where row 3's time goes inside a block: SM clocks by phase.

    python tools/attn_proj_phases.py [--half-w]

Copies the port into ``build/attn_proj_phases/`` with only
``csrc/attn_proj.cu`` (the attention + projection kernel, TPU row 3)
built, and that copy's kernel stamped with ``clock64()`` at the ends of
its phases by the first thread of each consumer warpgroup: the attention
of the warpgroup's heads (``attn``), the barrier after it, z = o U
(``z``), the first projection pass's main loop (``pass0_main``) and its
rank step and epilogue (``pass0_rest``), and the other passes
(``other_passes``).  The stamps go to a buffer behind the output.  Runs
ViT-B (B 64, N 197, E 768) and ViT-H/14 (B 64, N 257, E 1280, Dh 80) at
rank 8 and prints, per warpgroup, the median over the blocks of each
phase's clocks, and the copy's time back to back (20 calls between two
events).  ``--half-w`` also loads only the first of the two 64-column
boxes of each W tile (the other half of the tile holds stale bytes, so
the output is wrong): if the projection's passes were fed too slowly
from L2, they would take less time.  Needs one card.
"""

from __future__ import annotations

import argparse
import os
import shutil
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPY = os.path.join(HERE, "build", "attn_proj_phases")
SHAPES = (("vitb", 197, 768, 12), ("vith", 257, 1280, 16))
PHASES = {"attn": (0, 1), "barrier": (1, 2), "z": (2, 3),
          "pass0_main": (3, 4), "pass0_rest": (4, 5),
          "other_passes": (5, 6), "total": (0, 6)}
STAMPS = 16  # int64 slots a block: 8 a warpgroup


def _replace(src, old, new):
    if src.count(old) != 1:
        raise SystemExit(f"attn_proj.cu changed: {old[:60]!r} found "
                         f"{src.count(old)} times")
    return src.replace(old, new)


def make_copy(half_w: bool) -> None:
    shutil.rmtree(COPY, ignore_errors=True)
    os.makedirs(COPY)
    shutil.copytree(os.path.join(HERE, "cara_tpu_torch"),
                    os.path.join(COPY, "cara_tpu_torch"))
    shutil.copy(os.path.join(HERE, "chip_smoke.py"), COPY)
    csrc = os.path.join(COPY, "cara_tpu_torch", "csrc")
    for name in os.listdir(csrc):
        if name.endswith(".cu") and name != "attn_proj.cu":
            os.remove(os.path.join(csrc, name))
    path = os.path.join(COPY, "cara_tpu_torch", "ops", "cuda", "_build.py")
    src = open(path).read()
    i = src.index("_SIGNATURES = {")
    j = src.index("}\n", i)
    src = (src[:i] + '_SIGNATURES = {\n    "cara_attn_proj": [_P] * 7 + '
           '[_I] * 7 + [_F, _F, _P],\n' + src[j:])
    open(path, "w").write(src)
    path = os.path.join(COPY, "cara_tpu_torch", "ops", "cuda",
                        "fused_qkv_attention.py")
    src = _replace(
        open(path).read(),
        "    out = torch.empty((bsz, n, e), device=dev, dtype=torch.bfloat16)"
        "\n    code = lib.cara_attn_proj(",
        f"    out = torch.zeros(bsz * n * e + bsz * -(-n // 64) * "
        f"{STAMPS * 4}, device=dev, dtype=torch.bfloat16)\n"
        "    code = lib.cara_attn_proj(")
    open(path, "w").write(src)
    path = os.path.join(csrc, "attn_proj.cu")
    src = open(path).read()
    src = _replace(
        src, "  const Bars bb = group_bars(bar_base, w);\n",
        "  const Bars bb = group_bars(bar_base, w);\n"
        "  long long* stamps = reinterpret_cast<long long*>(\n"
        "      a.out + (size_t)gridDim.y * a.N * a.e) +\n"
        f"      ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * {STAMPS} + "
        f"w * {STAMPS // 2};\n"
        "  auto stamp = [&](int k) { if (wtid == 0) stamps[k] = clock64(); "
        "};\n  stamp(0);\n")
    barrier = ("  fence_proxy_async();\n  named_barrier(1, kConsumers);  "
               "// every head's o is in the tile\n")
    src = _replace(src, barrier, "  stamp(1);\n" + barrier + "  stamp(2);\n")
    src = _replace(
        src, "  // 3. y = o W + b + s (z V + cb), this warpgroup's",
        "  stamp(3);\n  int npass = 0;\n"
        "  // 3. y = o W + b + s (z V + cb), this warpgroup's")
    src = _replace(
        src, "    if (KT > 1) prelease(ip + KT - 2);\n    prelease(ip + KT - 1);"
        "\n    ip += KT;\n    // The epilogue's biases",
        "    if (KT > 1) prelease(ip + KT - 2);\n    prelease(ip + KT - 1);\n"
        "    ip += KT;\n    if (npass == 0) stamp(4);\n"
        "    // The epilogue's biases")
    src = _replace(
        src, " = pack_bf16(y0, y1);\n      }\n    }\n",
        " = pack_bf16(y0, y1);\n      }\n    }\n"
        "    if (npass == 0) stamp(5);\n    ++npass;\n")
    k = src.index("template <int DH, int RK>\nint launch(")
    end = src.rindex("  }\n}\n", 0, k)
    src = src[:end] + "  }\n  stamp(6);\n}\n" + src[end + len("  }\n}\n"):]
    if half_w:
        src = _replace(
            src, "        const int s = slot(kWTile);\n"
            "        tma_load_2d(ring + s * kWTile, m, &bb.pfull[s], c0, k);\n"
            "        tma_load_2d(ring + s * kWTile + kWBox, m, &bb.pfull[s], "
            "c0 + 64, k);",
            "        const int s = slot(rank ? kWTile : kWBox);\n"
            "        tma_load_2d(ring + s * kWTile, m, &bb.pfull[s], c0, k);\n"
            "        if (rank)\n"
            "          tma_load_2d(ring + s * kWTile + kWBox, m, &bb.pfull[s],"
            " c0 + 64, k);")
    open(path, "w").write(src)


def probe() -> None:
    """Run in the copy: the phases and the time back to back."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from cara_tpu_torch.ops.cuda import fused_qkv_attention as fqa

    dev = torch.device("cuda", 0)
    for tag, n, e, heads in SHAPES:
        inp = cs.kernel_inputs(dev, b=64, n=n, e=e, heads=heads,
                               hidden=4 * e, seed=1)
        a = inp["attn"]

        def call():
            return fqa.attn_proj_cuda(inp["qkv"], a["wp"], a["bp"], a["u2"],
                                      a["v2"], a["cb2"], heads, inp["sm"], n,
                                      1.0)

        for _ in range(3):
            out = call()
        torch.cuda.synchronize()
        st = out[64 * n * e:].view(torch.int64).reshape(
            -1, 2, STAMPS // 2).cpu().double()
        for w in range(2):
            print(f"{tag} warpgroup {w} median clocks: " + ", ".join(
                f"{k} {float((st[:, w, j] - st[:, w, i]).median()):.0f}"
                for k, (i, j) in PHASES.items()), flush=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        runs = []
        for _ in range(5):
            start.record()
            for _ in range(20):
                call()
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end) / 20)
        print(f"{tag} back to back: {statistics.median(runs):.4f} ms a call",
              flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--half-w", action="store_true",
                        help="load half of each W tile's bytes")
    parser.add_argument("--probe", action="store_true",
                        help="measure the copy in the working directory")
    args = parser.parse_args(argv)
    if args.probe:
        probe()
        return 0
    make_copy(args.half_w)
    return subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--probe"], cwd=COPY,
        env=dict(os.environ, PYTHONPATH=COPY)).returncode


if __name__ == "__main__":
    sys.exit(main())
