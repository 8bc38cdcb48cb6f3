"""The port's multi-task serving against the JAX package's.

``MultiTaskPredictor`` over one backbone and three CaRA tasks whose
delta scales (0.1, 10, 100) and class counts (2, 10, 5) differ, at CP
order 2 (the dense qkv delta, the XLA forms) and 4 (the kernels' plain
twins, through ``from_checkpoints``); ``from_checkpoints`` with
adapter-only files and a backbone npz, and its refusals;
``quantize="int8"`` on the shared backbone; the HTTP server's per-task
routes; the serve CLI's multi-task route.  Tiny model, numpy trees from
a seed, fp32 on the CPU, atol = rtol = 1e-4.
"""

import dataclasses
import json
import signal
import urllib.error
import urllib.request

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_port_serving import _images, _png
from test_torch_port_train import _fake_npz
from cara_tpu_torch import server as t_server
from cara_tpu_torch import serving as t_serving
from cara_tpu_torch.cli import serve as t_cli
from cara_tpu_torch.config import CaraConfig, get_model_config
from cara_tpu_torch.models import convert
from cara_tpu_torch.train import checkpoint as t_ckpt
from cara_tpu import config as j_config
from cara_tpu import serving as j_serving
from cara_tpu.models import ssf as j_ssf

TOL = dict(atol=1e-4, rtol=1e-4)
MODEL = "vit_tiny_test"
SCALES = {"svhn": 0.1, "dtd": 10.0, "cifar": 100.0}
CLASSES = {"svhn": 2, "dtd": 10, "cifar": 5}


def _tasks(order=4, rank=4, seed=20):
    """``{name: {"cara", "head", "scale", "cp_order"}}`` of numpy trees."""
    cfg = get_model_config(MODEL)
    rng = np.random.default_rng(seed)
    tasks = {}
    for i, (name, scale) in enumerate(SCALES.items()):
        cc = CaraConfig(rank=rank, cp_order=order)
        cara = convert.perturb_adapter(
            convert.init_cara_params(cfg, cc, seed + i), seed + 10 + i,
            std=0.05)
        nc = CLASSES[name]
        head = {"kernel": (0.1 * rng.standard_normal((64, nc))).astype(
                    np.float32),
                "bias": (0.1 * rng.standard_normal(nc)).astype(np.float32)}
        tasks[name] = {"cara": cara, "head": head, "scale": scale,
                       "cp_order": order}
    return tasks


def _backbone():
    return convert.init_vit_params(get_model_config(MODEL, num_classes=0), 3)


def _pair(tasks, params=None, **kw):
    params = _backbone() if params is None else params
    cfg = get_model_config(MODEL, num_classes=0)
    port = t_serving.MultiTaskPredictor(params, cfg, tasks, batch_size=4,
                                        dtype=torch.float32, device="cpu",
                                        **kw)
    ref = j_serving.MultiTaskPredictor(params, cfg, tasks, batch_size=4,
                                       dtype=jnp.float32, **kw)
    return port, ref


@pytest.mark.parametrize("order", [2])
def test_torch_multitask_logits_match_jax(order):
    """Each task's logits (sliced to its class count), over a full
    bucket and a one-image one, against JAX's; the scale rides the
    factors, so the port's tasks share every kernel call."""
    port, ref = _pair(_tasks(order))
    assert port.names == ref.names == list(SCALES)
    assert port.buckets == ref.buckets == (1, 4)
    x = _images(5, seed=order)
    for name in SCALES:
        out = port.logits(x, name)
        assert out.shape == (5, CLASSES[name])
        np.testing.assert_allclose(out, ref.logits(x, name), **TOL,
                                   err_msg=name)
        np.testing.assert_allclose(port.logits_async(x, name)(), out, **TOL)
        np.testing.assert_array_equal(port.predict(x, name), out.argmax(-1))


def test_torch_multitask_quantized_backbone_matches_jax():
    """``quantize="int8"`` on the shared backbone only: the block kernels
    become int8 codes, the stacked adapters and heads stay in the
    serving dtype."""
    port, ref = _pair(_tasks(), quantize="int8")
    assert port.quantize == "int8"
    assert port._base["blocks"]["qkv"]["kernel"]["q"].dtype == torch.int8
    assert port._cara["A1"].dtype == torch.float32
    x = _images(4, seed=9)
    for name in SCALES:
        np.testing.assert_allclose(port.logits(x, name),
                                   ref.logits(x, name), **TOL,
                                   err_msg=name)


def _adapter_files(tmp_path, tasks):
    paths = {}
    for name, t in tasks.items():
        paths[name] = str(tmp_path / f"{name}_adapter.npz")
        t_ckpt.save_adapter(paths[name], t["cara"], t["head"],
                            {"scale": t["scale"], "cp_order": t["cp_order"],
                             "model": MODEL, "dataset": name})
    return paths


def test_torch_multitask_from_checkpoints_matches_jax(tmp_path):
    """Adapter-only files and a backbone npz through both packages'
    ``from_checkpoints``; then the refusals JAX makes, and the port's of
    the adapter families it does not serve yet."""
    tasks = _tasks()
    paths = _adapter_files(tmp_path, tasks)
    bb = str(tmp_path / "backbone.npz")
    _fake_npz(bb, get_model_config(MODEL))
    port = t_serving.MultiTaskPredictor.from_checkpoints(
        paths, MODEL, backbone=bb, batch_size=4, dtype=torch.float32,
        device="cpu")
    ref = j_serving.MultiTaskPredictor.from_checkpoints(
        paths, MODEL, backbone=bb, batch_size=4, dtype=jnp.float32)
    x = _images(3, seed=5)
    for name in SCALES:
        np.testing.assert_allclose(port.logits(x, name),
                                   ref.logits(x, name), **TOL, err_msg=name)
    kw = dict(batch_size=4, device="cpu")
    with pytest.raises(ValueError, match="pass backbone="):
        t_serving.MultiTaskPredictor.from_checkpoints(paths, MODEL, **kw)
    with pytest.raises(ValueError, match="disagree on the backbone"):
        t_serving.MultiTaskPredictor.from_checkpoints(
            paths, "vit_base_patch16_224_in21k", backbone=bb, **kw)
    no_scale = str(tmp_path / "no_scale.npz")
    t_ckpt.save_adapter(no_scale, tasks["svhn"]["cara"],
                        tasks["svhn"]["head"], {"cp_order": 4})
    with pytest.raises(ValueError, match="records no delta scale"):
        t_serving.MultiTaskPredictor.from_checkpoints(
            {"a": no_scale}, MODEL, backbone=bb, **kw)


@pytest.mark.parametrize("group, error, match", [
    ("rank", ValueError, "share CP rank/order"),
    ("order", ValueError, "share CP rank/order"),
    ("moe", ValueError, "MoE adapter"),
    ("ssf", ValueError, "low-rank factor trees"),
])
def test_torch_multitask_refuses_mixed_groups_as_jax(group, error, match):
    """Mixed ranks or orders, MoE trees and an SSF group raise as JAX
    raises them (a group stacks low-rank factor trees)."""
    tasks = _tasks()
    if group == "rank":
        tasks["dtd"] = _tasks(rank=8)["dtd"]
    elif group == "order":
        tasks["dtd"] = _tasks(order=3)["dtd"]
    elif group == "moe":
        tasks["dtd"] = dict(tasks["dtd"], cara={"experts": {},
                                                 "router": {}})
    else:
        ssf = jax.device_get(j_ssf.init_ssf_params(
            jax.random.PRNGKey(0), j_config.get_model_config(MODEL),
            j_config.CaraConfig(method="ssf", weight_dropout=0.0)))
        tasks = {n: dict(t, cara=ssf) for n, t in tasks.items()}
    cfg = get_model_config(MODEL, num_classes=0)
    with pytest.raises(error, match=match):
        t_serving.MultiTaskPredictor(_backbone(), cfg, tasks, device="cpu")
    with pytest.raises(ValueError, match=match):
        j_serving.MultiTaskPredictor(_backbone(), cfg, tasks)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return json.loads(r.read())


def _post(port, query, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict{query}", data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def test_torch_multitask_server_routes_by_task():
    """One batcher a task: ``?task=`` picks the adapter (the answer is
    that task's top class), no task is a 400, an unknown one a 404;
    ``/healthz`` lists the tasks and ``/stats`` counts each."""
    port, _ = _pair(_tasks())
    srv = t_server.InferenceServer(port, port=0, max_wait_ms=5.0,
                                   top=3).start(warmup=False)
    try:
        body = _png(1)
        img = t_server.decode_image_bytes(body, 32)[None]
        for name in ("svhn", "cifar", "cifar"):
            code, ans = _post(srv.port, f"?task={name}", body)
            assert code == 200
            assert ans["class"] == int(port.logits(img, name).argmax())
            assert max(ans["classes"]) < CLASSES[name]
        code, ans = _post(srv.port, "", body)
        assert code == 400 and ans["tasks"] == list(SCALES)
        code, ans = _post(srv.port, "?task=nope", body)
        assert code == 404 and "unknown task" in ans["error"]
        assert _get(srv.port, "/healthz")["tasks"] == list(SCALES)
        stats = _get(srv.port, "/stats")
        assert sorted(stats) == sorted(SCALES)
        assert [stats[n]["requests"] for n in SCALES] == [1, 0, 2]
    finally:
        srv.close()


def test_torch_serve_cli_multitask_route(tmp_path, monkeypatch):
    """Several ``--ckpt`` (``name=path``, or a path named by its meta's
    dataset) and ``--backbone`` build a ``MultiTaskPredictor``; duplicate
    names and the single-task options are refused."""
    tasks = _tasks()
    paths = _adapter_files(tmp_path, tasks)
    bb = str(tmp_path / "backbone.npz")
    _fake_npz(bb, get_model_config(MODEL))
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
    monkeypatch.setattr(signal, "signal", lambda *args: None)
    common = ["--model", MODEL, "--backbone", bb, "--device", "cpu",
              "--dtype", "float32", "--no-warmup", "--max-batch", "4"]
    argv = ["--ckpt", f"a={paths['svhn']}", "--ckpt", paths["cifar"]]
    assert t_cli.main(argv + common) == 0
    (pred,) = served
    assert isinstance(pred, t_serving.MultiTaskPredictor)
    assert pred.names == ["a", "cifar"]
    ref = t_serving.MultiTaskPredictor.from_checkpoints(
        {"a": paths["svhn"], "cifar": paths["cifar"]}, MODEL, backbone=bb,
        batch_size=4, dtype=torch.float32, device="cpu")
    x = _images(2, seed=6)
    np.testing.assert_allclose(pred.logits(x, "cifar"),
                               ref.logits(x, "cifar"), **TOL)
    with pytest.raises(SystemExit, match="duplicate task name"):
        t_cli.main(["--ckpt", f"x={paths['svhn']}", "--ckpt",
                    f"x={paths['dtd']}"] + common)
    for extra in (["--no-merge"], ["--scale", "2"], ["--num-classes", "3"]):
        with pytest.raises(SystemExit, match="single-task"):
            t_cli.main(argv + common + extra)
    assert dataclasses.is_dataclass(pred.cfg) and pred.cfg.num_classes == 5
