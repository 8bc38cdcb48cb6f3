"""``cli.export``, ``--merged-eval`` and ``cli.predict`` of the port
against the JAX package's.

Every npz mode of ``cli.export`` on one checkpoint through both packages
(arrays within 1e-6, the same meta) and the refusals; ``vit_cp --evaluate
--merged-eval`` gives JAX's accuracy; ``cli.predict`` on PNG files that
the test writes gives JAX's top-k classes, its scores within 1e-3 (both
in fp32, both decoding with PIL).
"""

import json

import numpy as np
import pytest

from cara_tpu_torch.cli import export as t_export
from cara_tpu_torch.cli import predict as t_predict
from cara_tpu_torch.cli import vit_cp as t_cli
from cara_tpu_torch.config import CaraConfig, get_model_config
from cara_tpu_torch.models import convert
from cara_tpu_torch.train import checkpoint as t_ckpt
from cara_tpu.cli import export as j_export
from cara_tpu.cli import predict as j_predict
from cara_tpu.cli import vit_cp as j_cli
from cara_tpu.train import checkpoint as j_ckpt

MODEL = "vit_tiny_test"


def _checkpoint(path, scale=10.0, model=MODEL, num_classes=2):
    """A tiny CaRA checkpoint as ``fit`` writes it: backbone + head +
    a perturbed rank-4 adapter, the CaraConfig and model in meta."""
    cfg = get_model_config(MODEL, num_classes=num_classes)
    cc = CaraConfig(rank=4, scale=scale)
    params = convert.init_vit_params(cfg, 0)
    cara = convert.perturb_adapter(convert.init_cara_params(cfg, cc, 1), 2,
                                   std=0.05)
    meta = {"rank": 4, "cp_order": 4, "weight_dropout": 0.1,
            "dataset": "patch_camelyon"}
    if scale is not None:
        meta["scale"] = scale
    if model is not None:
        meta["model"] = model
    t_ckpt.save_model(str(path), params, cara, meta)
    return str(path)


def _arrays(path):
    with np.load(path) as z:
        meta = (json.loads(bytes(z["__meta__"].tolist()).decode())
                if "__meta__" in z.files else None)
        return {k: z[k] for k in z.files if k != "__meta__"}, meta


@pytest.mark.parametrize("mode", ["merged", "adapter", "full"])
def test_torch_export_matches_jax(tmp_path, mode):
    ckpt = _checkpoint(tmp_path / "in.npz")
    j_out, t_out = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    j_export.main(["--ckpt", ckpt, "--out", j_out, "--mode", mode])
    assert t_export.main(["--ckpt", ckpt, "--out", t_out, "--mode", mode,
                          "--device", "cpu"]) == t_out
    want, want_meta = _arrays(j_out)
    got, got_meta = _arrays(t_out)
    assert got_meta == want_meta
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=1e-6,
                                   err_msg=k)
    if mode == "adapter":
        assert t_ckpt.is_adapter_checkpoint(t_out)
        assert j_ckpt.is_adapter_checkpoint(t_out)


@pytest.mark.parametrize("extra, match", [
    (["--mode", "stablehlo"], "PEFT zoo"),
    (["--tome-r", "4"], "only applies to --mode stablehlo"),
    (["--quantize", "int8"], "only applies to --mode stablehlo"),
])
def test_torch_export_refuses_what_is_not_ported(tmp_path, extra, match):
    ckpt = _checkpoint(tmp_path / "in.npz")
    with pytest.raises(SystemExit, match=match):
        t_export.main(["--ckpt", ckpt, "--out", str(tmp_path / "o.npz"),
                       "--device", "cpu", *extra])


def test_torch_export_checks_scale_and_model_as_jax(tmp_path):
    no_scale = _checkpoint(tmp_path / "a.npz", scale=None)
    no_model = _checkpoint(tmp_path / "b.npz", model=None)
    out = str(tmp_path / "o.npz")
    for main in (j_export.main, t_export.main):
        dev = ["--device", "cpu"] if main is t_export.main else []
        for mode in ("merged", "adapter"):
            with pytest.raises(SystemExit, match="no delta scale"):
                main(["--ckpt", no_scale, "--out", out, "--mode", mode,
                      *dev])
        with pytest.raises(SystemExit, match="no model name"):
            main(["--ckpt", no_model, "--out", out, *dev])
        # full re-saves verbatim without a scale; --scale supplies one
        main(["--ckpt", no_scale, "--out", out, "--mode", "full", *dev])
        main(["--ckpt", no_scale, "--out", out, "--scale", "3", *dev])
        assert t_ckpt.load_model(out)[2]["scale"] == 3.0
    t_ckpt.save_model(str(tmp_path / "c.npz"), {"head": {"bias": np.ones(2)}})
    with pytest.raises(SystemExit, match="no adapter subtree"):
        t_export.main(["--ckpt", str(tmp_path / "c.npz"), "--out", out])


def test_torch_merged_eval_matches_jax(tmp_path, capsys):
    ckpt = _checkpoint(tmp_path / "in.npz")
    args = ["--synthetic", "--dataset", "patch_camelyon", "--model", MODEL,
            "--dim", "4", "--eval-batch-size", "8", "--synthetic-size", "64",
            "--dtype", "float32", "--backbone", str(tmp_path / "none.npz"),
            "--evaluate", ckpt]
    accs = {}
    for name, main, extra in (("jax", j_cli.main, []),
                              ("port", t_cli.main, ["--device", "cpu"])):
        for merged in (False, True):
            accs[name, merged] = main(
                args + extra + (["--merged-eval"] if merged else []))
    assert accs["port", True] == pytest.approx(accs["jax", True], abs=1e-9)
    assert accs["port", True] == pytest.approx(accs["port", False],
                                               abs=1e-9)
    assert "Accuracy:" in capsys.readouterr().out


def test_torch_predict_matches_jax(tmp_path, capsys, monkeypatch):
    from PIL import Image

    import cara_tpu.data.native as j_native
    from cara_tpu import serving as j_serving
    import jax.numpy as jnp

    ckpt = _checkpoint(tmp_path / "in.npz")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(3):
        path = str(tmp_path / f"img{i}.png")
        Image.fromarray(rng.integers(0, 256, (40, 40, 3), np.uint8)).save(
            path)
        paths.append(path)

    class F32(j_serving.Predictor):
        @classmethod
        def from_checkpoint_auto(cls, *args, **kw):
            return super().from_checkpoint_auto(*args, dtype=jnp.float32,
                                                **kw)

    def no_native(*args, **kw):
        raise RuntimeError("the port decodes with PIL")

    monkeypatch.setattr(j_predict, "Predictor", F32)
    monkeypatch.setattr(j_native, "NativeBatchDecoder", no_native)
    for merge in ([], ["--no-merge"]):
        common = ["--ckpt", ckpt, "--model", MODEL, "--top", "2", *merge,
                  *paths]
        want = j_predict.main(common)
        got = t_predict.main(common + ["--device", "cpu", "--dtype",
                                       "float32"])
        assert [r["classes"] for r in got] == [r["classes"] for r in want]
        np.testing.assert_allclose([r["scores"] for r in got],
                                   [r["scores"] for r in want], atol=1e-3)
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["image"] \
        == paths[-1]
    with pytest.raises(SystemExit, match="PEFT zoo"):
        t_predict.main(["--ckpt", ckpt, "--exported", "x", paths[0]])
    # ToMe (test_torch_port_tome.py): the merged path, as JAX's
    common = ["--ckpt", ckpt, "--model", MODEL, "--top", "2", "--tome-r",
              "2", *paths]
    want = j_predict.main(common)
    got = t_predict.main(common + ["--device", "cpu", "--dtype", "float32"])
    assert [r["classes"] for r in got] == [r["classes"] for r in want]
    np.testing.assert_allclose([r["scores"] for r in got],
                               [r["scores"] for r in want], atol=1e-3)
    with pytest.raises(SystemExit, match="drop --no-merge"):
        t_predict.main(["--ckpt", ckpt, "--tome-r", "2", "--no-merge",
                        paths[0]])
    # a reference .pt of the same weights predicts the same (its scale
    # comes from --scale)
    from cara_tpu_torch.models.torch_export import save_torch_checkpoint

    params, cara, meta = t_ckpt.load_model(ckpt)
    pt = str(tmp_path / "same.pt")
    save_torch_checkpoint(pt, params, cara, get_model_config(
        MODEL, **meta.get("model_overrides", {})), 4)
    got_pt = t_predict.main(["--ckpt", pt, "--model", MODEL, "--top", "2",
                             "--scale", str(meta["scale"]), "--device",
                             "cpu", "--dtype", "float32", *paths])
    assert [r["classes"] for r in got_pt] == [r["classes"] for r in got]
