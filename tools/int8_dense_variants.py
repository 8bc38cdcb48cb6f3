"""Where TPU row 18's time goes on the card: ``csrc/int8_dense.cu`` built
as it is and in three variants, each timed at the smoke's large-M shapes.

    python tools/int8_dense_variants.py [--out build/int8_variants.json]

The variants are copies of the source with a part cut out, built with
``nvcc`` into their own libraries under ``build/int8_variants`` (nothing
of the package changes):

- ``kernel``: the source as it is (its output is held against the fp32
  plain version);
- ``no_convert``: the int8 tiles are not converted (the products read
  whatever the converted slots hold);
- ``no_products``: no ``wgmma`` is issued;
- ``neither``: only the TMA ring, the barriers and the epilogue.

Each is called through its own ``cara_int8_dense`` on the same inputs
(direct path, the wrapper's block width), 20 calls between two CUDA
events, the median of five such runs.  Prints the card's name and power
limit, one line a (shape, variant) and, with ``--out``, the numbers as
JSON.  Needs one card and ``nvcc``; run from the repository root.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "cara_tpu_torch", "csrc", "int8_dense.cu")
OUT_DIR = os.path.join(ROOT, "build", "int8_variants")

_LOAD = """    for (int j = 0; j < PER; ++j)
      raw[j] = *reinterpret_cast<const uint2*>("""
_STORE = "      *reinterpret_cast<uint4*>(bs + dst[(j * RPW) & 1] +"
_WGMMA = "wgmma_ss<BN, 0, 1>(acc, da + 2 * kk, db + 128 * kk, 1);"
_NO_CONVERT = [(_LOAD, _LOAD.replace("j < PER", "j < 0")),
               (_STORE, "      if (j < 0)" + _STORE[5:])]
_NO_PRODUCTS = [(_WGMMA, "if (kk < 0) " + _WGMMA)]
VARIANTS = {"kernel": [], "no_convert": _NO_CONVERT,
            "no_products": _NO_PRODUCTS, "neither": _NO_CONVERT + _NO_PRODUCTS}
# (M, K, N): ViT-B's qkv and fc2 sites at batch 64, ViT-H/14's fc2.
SHAPES = ((12608, 768, 2304), (12608, 3072, 768), (16448, 5120, 1280))


def build(nvcc: str) -> dict:
    """name -> the path of its library, every variant built in parallel."""
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(SRC) as f:
        text = f.read()
    procs = {}
    for name, subs in VARIANTS.items():
        src = text
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"{name}: the source changed; no {old!r}")
            src = src.replace(old, new)
        path = os.path.join(OUT_DIR, f"int8_{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        lib = os.path.join(OUT_DIR, f"lib_int8_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-shared", "-I",
             os.path.dirname(SRC), "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the numbers here (JSON)")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from cara_tpu_torch.ops.cuda import _build
    from cara_tpu_torch.ops.cuda import int8_dense as i8

    if not torch.cuda.is_available():
        print("int8_dense_variants: no CUDA device", file=sys.stderr)
        return 2
    card = cs.nvidia_smi_line()
    print(card, flush=True)
    libs = build(_build._nvcc())
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    results = []
    for m, k, n in SHAPES:
        t = cs.int8_inputs(dev, m, k, n)
        out = torch.empty((m, n), device=dev, dtype=torch.bfloat16)
        bn = i8.plan(m, k, n, i8.sm_count(dev))[0]
        for name, path in libs.items():
            fn = ctypes.CDLL(path).cara_int8_dense
            fn.argtypes = _build._SIGNATURES["cara_int8_dense"]
            fn.restype = ctypes.c_int

            def call():
                return fn(t["x"].data_ptr(), t["wq"].data_ptr(),
                          t["scale"].data_ptr(), t["b"].data_ptr(),
                          out.data_ptr(), None, m, k, n, bn, 1, k, stream)

            _build.check(call(), f"int8_dense ({name})")
            torch.cuda.synchronize()
            err = None
            if name == "kernel":
                ref = i8.int8_dense_plain(t["x"].float(), t["wq"],
                                          t["scale"].float(), t["b"].float())
                err = (out.float() - ref).abs().max().item()
            runs = []
            for _ in range(5):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(20):
                    call()
                end.record()
                end.synchronize()
                runs.append(start.elapsed_time(end) / 20)
            ms = statistics.median(runs)
            res = {"m": m, "k": k, "n": n, "bn": bn, "variant": name,
                   "ms": ms, "tflops": 2 * m * k * n / ms / 1e9,
                   "max_abs_err": err}
            results.append(res)
            print(json.dumps(res), flush=True)
        del t, out
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
