"""The port's checkpoints, Predictor and HTTP server against the JAX package.

Tiny model (``vit_tiny_test``, a 64-wide pre_logits layer, rank-4 CaRA),
fp32 on the CPU, atol = rtol = 1e-4.
"""

import io
import json
import os
import signal
import urllib.request

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cara_tpu_torch import config as t_config
from cara_tpu_torch import server as t_server
from cara_tpu_torch import serving as t_serving
from cara_tpu_torch.models import convert
from cara_tpu_torch.train import checkpoint as t_ckpt
from cara_tpu import serving as j_serving
from cara_tpu.train import checkpoint as j_ckpt

TOL = dict(atol=1e-4, rtol=1e-4)
MODEL = "vit_tiny_test"
OVERRIDES = {"repr_size": 64}
META = {"method": "cara", "scale": 4.0, "cp_order": 4,
        "weight_dropout": 0.1, "model_overrides": OVERRIDES}


@pytest.fixture(scope="module")
def trees():
    cfg = t_config.get_model_config(MODEL, **OVERRIDES)
    cc = t_config.CaraConfig(rank=4, scale=META["scale"])
    params = convert.init_vit_params(cfg, 11)
    cara = convert.perturb_adapter(convert.init_cara_params(cfg, cc, 12),
                                   13, std=0.1)
    return params, cara


def _images(n, size=32, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


def _port_pred(path, merge=True, **kw):
    return t_serving.Predictor.from_checkpoint_auto(
        path, MODEL, merge=merge, device="cpu", dtype=torch.float32, **kw)


def _jax_pred(path, merge=True, **kw):
    return j_serving.Predictor.from_checkpoint_auto(
        path, MODEL, merge=merge, dtype=jnp.float32, **kw)


def test_jax_checkpoint_loads_in_port(trees, tmp_path):
    params, cara = trees
    path = str(tmp_path / "jax.npz")
    j_ckpt.save_model(path, jax.tree_util.tree_map(jnp.asarray, params),
                      jax.tree_util.tree_map(jnp.asarray, cara), META)
    p_params, p_cara, meta = t_ckpt.load_model(path)
    assert meta == META
    np.testing.assert_array_equal(p_cara["A1"], cara["A1"])
    cc = t_ckpt.infer_cara_cfg(p_cara, meta)
    assert (cc.rank, cc.scale, cc.cp_order) == (4, 4.0, 4)
    x = _images(3)
    np.testing.assert_allclose(_port_pred(path).logits(x),
                               _jax_pred(path).logits(x), **TOL)


def test_port_checkpoint_loads_in_jax(trees, tmp_path):
    params, cara = trees
    path = str(tmp_path / "port.npz")
    t_ckpt.save_model(path, convert.params_from_numpy(params, "cpu"),
                      convert.params_from_numpy(cara, "cpu"), META)
    j_params, j_cara, meta = j_ckpt.load_model(path)
    assert meta == META
    np.testing.assert_array_equal(np.asarray(j_cara["P2"]), cara["P2"])
    x = _images(3, seed=1)
    np.testing.assert_allclose(_port_pred(path, merge=False).logits(x),
                               _jax_pred(path, merge=False).logits(x), **TOL)


def test_checkpoint_without_scale_is_refused(trees, tmp_path):
    params, cara = trees
    path = str(tmp_path / "noscale.npz")
    t_ckpt.save_model(path, params, cara, {"cp_order": 4})
    with pytest.raises(ValueError, match="no delta scale"):
        _port_pred(path)
    assert _port_pred(path, scale=2.0)._params is not None


@pytest.mark.parametrize("merge", [True, False], ids=["merged", "adapter"])
def test_predictor_matches_jax_with_buckets(trees, tmp_path, merge):
    params, cara = trees
    path = str(tmp_path / "ckpt.npz")
    t_ckpt.save_model(path, params, cara, META)
    port = _port_pred(path, merge=merge, batch_size=4, buckets="auto")
    ref = _jax_pred(path, merge=merge, batch_size=4, buckets="auto")
    assert port.buckets == ref.buckets == (1, 4)
    x = _images(5, seed=2)  # one full chunk of 4, then a 1-image bucket
    out = port.logits(x)
    assert out.shape == (5, 10) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref.logits(x), **TOL)
    np.testing.assert_allclose(port.logits_async(x)(), out, **TOL)
    np.testing.assert_array_equal(port.predict(x), np.argmax(out, -1))


def _png(seed, size=40):
    from PIL import Image

    rng = np.random.RandomState(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.randint(0, 255, (size, size, 3), np.uint8)).save(
        buf, format="PNG")
    return buf.getvalue()


def test_server_answers_png_predict(trees, tmp_path):
    params, cara = trees
    path = str(tmp_path / "srv.npz")
    t_ckpt.save_model(path, params, cara, META)
    pred = _port_pred(path, batch_size=4)
    srv = t_server.InferenceServer(pred, port=0, max_wait_ms=20.0,
                                   top=3).start()
    try:
        body = _png(0)
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/predict", data=body,
            method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
            ans = json.loads(r.read())
        img = t_server.decode_image_bytes(body, pred.cfg.image_size)
        want = pred.logits(img[None])[0]
        assert ans["class"] == int(np.argmax(want))
        assert len(ans["classes"]) == 3 and ans["batched_with"] >= 1
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/healthz", timeout=10) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["max_batch"] == 4
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/stats", timeout=10) as r:
            assert json.loads(r.read())["requests"] == 1
    finally:
        srv.close()


def test_cli_refuses_unported_paths(tmp_path):
    from cara_tpu_torch.cli import serve as t_cli

    # --tome-r is ported (test_torch_port_tome.py): it serves a single
    # merged checkpoint, as in JAX
    with pytest.raises(SystemExit, match="single merged checkpoint"):
        t_cli.main(["--ckpt", os.fspath(tmp_path / "x.npz"),
                    "--tome-r", "2", "--no-merge"])
    with pytest.raises(SystemExit, match="not yet ported"):
        t_cli.main(["--ckpt", "a.npz", "--exported", "x"])
    # several checkpoints serve as tasks (test_torch_port_multitask.py);
    # the single-task options are refused with them
    with pytest.raises(SystemExit, match="single-task option"):
        t_cli.main(["--ckpt", "a.npz", "--ckpt", "b.npz", "--no-merge"])


@pytest.mark.parametrize("mode", ["int8", "w8a8"])
def test_cli_quantize_reaches_predictor(trees, tmp_path, monkeypatch, mode):
    """``--quantize`` parses and builds a quantized Predictor, which the
    server is handed; an unknown mode is refused by the parser."""
    from cara_tpu_torch.cli import serve as t_cli

    params, cara = trees
    path = str(tmp_path / "q.npz")
    t_ckpt.save_model(path, params, cara, META)
    served = []

    class Server:
        def __init__(self, pred, **kw):
            served.append(pred)
            self.port = 0

        def serve_forever(self):
            raise KeyboardInterrupt

        def close(self):
            pass

    monkeypatch.setattr(t_server, "InferenceServer", Server)
    # main() installs a SIGTERM handler; keep this process's own
    monkeypatch.setattr(signal, "signal", lambda *args: None)
    assert t_cli.main(["--ckpt", path, "--model", MODEL, "--device", "cpu",
                       "--dtype", "float32", "--no-warmup", "--max-batch",
                       "4", "--quantize", mode]) == 0
    (pred,) = served
    assert pred.quantize == mode
    kernel = pred._params["blocks"]["fc1"]["kernel"]
    assert kernel["qa" if mode == "w8a8" else "q"].dtype == torch.int8
    x = _images(2, seed=4)
    np.testing.assert_allclose(pred.logits(x), _port_pred(
        path, batch_size=4, quantize=mode).logits(x), **TOL)
    with pytest.raises(SystemExit):
        t_cli.main(["--ckpt", path, "--quantize", "bogus"])
