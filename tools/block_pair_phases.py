"""Where row 19's time goes inside a block: SM clocks by phase.

    python tools/block_pair_phases.py

Copies the port into ``build/block_pair_phases/`` with only
``csrc/block_pair.cu`` and ``csrc/block_pair_quick.cu`` (the whole-block
eval kernel after the qkv site, TPU row 19) built, and that copy's kernel
stamped with ``clock64()`` by the first thread of each consumer
warpgroup: the wait for the tile's q and the cluster's first event
(``q``), the attention of the block's heads (``attn``), the wait for
every block's o (``o_event``), z2 and the projection with the residual
(``proj``), LN2 with its cluster sum and xa2's bulk copies (``ln2``),
z1 (``z1``), then summed over the hidden steps: fc1 with its rank step
and activation (``fc1``), the wait for the other blocks to free the h
slots (``slot_wait``), h's store, its bulk copies to every block and the
wait for every block's h (``h_event``), fc2 and z2' on the step's chunks
(``fc2``); last V2' and the output (``tail``).
The stamps go to a buffer behind the output.  Runs ViT-B (B 64, N 197, E
768), CLIP ViT-L/14 (N 257, E 1024, quick_gelu) and ViT-H/14 (N 257, E
1280, Dh 80) at rank 8 on a seeded qkv (the qkv site is not run) and
prints, per warpgroup, the median over the blocks of each phase's
clocks, and the copy's time back to back (20 calls between two events).
Needs one card.
"""

from __future__ import annotations

import os
import shutil
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPY = os.path.join(HERE, "build", "block_pair_phases")
# tag, N, E, heads, hidden, act (cara_block_pair's code)
SHAPES = (("vitb", 197, 768, 12, 3072, 0), ("clip", 257, 1024, 16, 4096, 1),
          ("vith", 257, 1280, 16, 5120, 0))
STAMPS = 32  # int64 slots a block: 16 a warpgroup
PHASES = {"q": (0, 1), "attn": (1, 2), "o_event": (2, 3), "proj": (3, 4),
          "ln2": (4, 5), "z1": (5, 6), "tail": (7, 8), "total": (0, 8)}
SUMS = {"fc1": 9, "slot_wait": 10, "h_event": 11, "fc2": 12}


def _replace(src, old, new):
    if src.count(old) != 1:
        raise SystemExit(f"block_pair.cuh changed: {old[:60]!r} found "
                         f"{src.count(old)} times")
    return src.replace(old, new)


def make_copy() -> None:
    shutil.rmtree(COPY, ignore_errors=True)
    os.makedirs(COPY)
    shutil.copytree(os.path.join(HERE, "cara_tpu_torch"),
                    os.path.join(COPY, "cara_tpu_torch"))
    shutil.copy(os.path.join(HERE, "chip_smoke.py"), COPY)
    csrc = os.path.join(COPY, "cara_tpu_torch", "csrc")
    for name in os.listdir(csrc):
        if name.endswith(".cu") and not name.startswith("block_pair"):
            os.remove(os.path.join(csrc, name))
    path = os.path.join(COPY, "cara_tpu_torch", "ops", "cuda", "_build.py")
    src = open(path).read()
    i = src.index("_SIGNATURES = {")
    j = src.index("}\n", i)
    src = (src[:i] + '_SIGNATURES = {\n    "cara_block_pair": [_P] * 20 + '
           '[_I] * 9 + [_F] * 3 + [_P],\n' + src[j:])
    open(path, "w").write(src)
    path = os.path.join(csrc, "block_pair.cuh")
    src = open(path).read()
    src = _replace(
        src, "  const uint32_t cbar_off = smem_u32(cbar) - smem_u32(smem);\n",
        "  const uint32_t cbar_off = smem_u32(cbar) - smem_u32(smem);\n"
        "  long long* stamps = reinterpret_cast<long long*>(\n"
        "      a.out + (size_t)gridDim.z * a.N * a.e) +\n"
        "      (((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +\n"
        f"       blockIdx.x) * {STAMPS} + w * {STAMPS // 2};\n"
        "  long long sums[4] = {0, 0, 0, 0}, t_prev = 0;\n"
        "  auto stamp = [&](int k) { if (wtid == 0) stamps[k] = clock64(); "
        "};\n"
        "  auto lap = [&](int k) { const long long now = clock64(); "
        "sums[k] += now - t_prev; t_prev = now; };\n"
        "  stamp(0);\n")
    src = _replace(src, "  wait_event(0);\n", "  wait_event(0);\n  stamp(1);\n")
    src = _replace(src, "  signal(1, true);  // event 1",
                   "  stamp(2);\n  signal(1, true);  // event 1")
    src = _replace(src, "  wait_event(1);\n", "  wait_event(1);\n  stamp(3);\n")
    src = _replace(src, "  // 3. LN2 of x_mid:",
                   "  stamp(4);\n  // 3. LN2 of x_mid:")
    src = _replace(src, "  mbar_wait(xbar, 0);\n",
                   "  mbar_wait(xbar, 0);\n  stamp(5);\n")
    src = _replace(
        src, "  ib += NU;\n  float zh[ZN / 2];",
        "  ib += NU;\n  stamp(6);\n  t_prev = clock64();\n"
        "  float zh[ZN / 2];")
    src = _replace(src, "    if (s >= nsteps || j >= nch) return;\n"
                   "    float a1[16];",
                   "    if (s >= nsteps || j >= nch) return;\n"
                   "    const long long f0 = clock64();\n    float a1[16];")
    src = _replace(src, "    }\n  };\n  // Per step s",
                   "    }\n    sums[0] += clock64() - f0;\n  };\n"
                   "  // Per step s")
    src = _replace(src, "    if (nbuf == 1 && s > 0) wait_event(2 + s);",
                   "    t_prev = clock64();\n"
                   "    if (nbuf == 1 && s > 0) wait_event(2 + s);\n"
                   "    lap(1);")
    src = _replace(src, "    fc1(s + 1);\n",
                   "    lap(2);\n    fc1(s + 1);\n    t_prev = clock64();\n")
    src = _replace(src, "    mbar_wait(&hbar[set], (s / nbuf) & 1);\n",
                   "    mbar_wait(&hbar[set], (s / nbuf) & 1);\n    lap(2);\n")
    src = _replace(src, "    if (nbuf == 1 && s + 1 < nsteps) signal(3 + s, false);",
                   "    lap(3);\n"
                   "    if (nbuf == 1 && s + 1 < nsteps) signal(3 + s, false);")
    src = _replace(
        src, "  if (!has) return;\n  uint32_t zf2[RK][4];",
        "  stamp(7);\n  if (wtid == 0)\n    for (int i = 0; i < 4; ++i) "
        "stamps[9 + i] = sums[i];\n  if (!has) { stamp(8); return; }\n"
        "  uint32_t zf2[RK][4];")
    k = src.index("// The device pointers of one call.")
    end = src.rindex("  }\n}\n", 0, k)
    src = src[:end] + "  }\n  stamp(8);\n}\n" + src[end + len("  }\n}\n"):]
    open(path, "w").write(src)


def probe() -> None:
    """Run in the copy: the phases and the time back to back."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from cara_tpu_torch.ops.cuda import _build, _bwd

    dev = torch.device("cuda", 0)
    lib = _build.lib()
    for tag, n, e, heads, hidden, act in SHAPES:
        inp = cs.kernel_inputs(dev, b=64, n=n, e=e, heads=heads,
                               hidden=hidden, seed=1)
        a, m = inp["attn"], inp["mlp"]
        k = -(-e // 256)
        blocks = k * -(-n // 64) * 64
        out = torch.zeros(64 * n * e + blocks * STAMPS * 4, device=dev,
                          dtype=torch.bfloat16)
        u2, mu1, mu2 = (_bwd.pad_cols8(t) for t in (a["u2"], m["u1"],
                                                   m["u2"]))
        ptrs = [inp["qkv"], a["x"], a["wp"], a["bp"], u2, a["v2"], a["cb2"],
                m["ln_scale"], m["ln_bias"], m["w1"], m["b1"], mu1, m["v1"],
                m["cb1"], m["w2"], m["b2"], mu2, m["v2"], m["cb2"], out]

        def call():
            _build.check(lib.cara_block_pair(
                *[t.data_ptr() for t in ptrs], 64, n, heads, e // heads,
                hidden, n, a["u2"].shape[1], u2.shape[1], act,
                float(inp["sm"]), 1.0, 1e-6, _build.stream_ptr(dev)),
                "block_pair")

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        st = out[64 * n * e:].view(torch.int64).reshape(
            -1, 2, STAMPS // 2).cpu().double()
        for w in range(2):
            parts = [f"{name} {float((st[:, w, j] - st[:, w, i]).median()):.0f}"
                     for name, (i, j) in PHASES.items()]
            parts += [f"{name} {float(st[:, w, i].median()):.0f}"
                      for name, i in SUMS.items()]
            print(f"{tag} (cluster of {k}) warpgroup {w} median clocks: "
                  + ", ".join(parts), flush=True)
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
        print(f"{tag} back to back: {statistics.median(runs):.4f} ms a call "
              "(the kernel after the qkv site)", flush=True)
        del inp, out, ptrs
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if "--probe" in argv:
        probe()
        return 0
    make_copy()
    return subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--probe"], cwd=COPY,
        env=dict(os.environ, PYTHONPATH=COPY)).returncode


if __name__ == "__main__":
    sys.exit(main())
