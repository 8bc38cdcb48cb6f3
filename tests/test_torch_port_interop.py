"""The port's importers and exporter of torch checkpoints against the JAX
package's.

``models/torch_import.py`` on a ``.pt`` that ``cara_tpu``'s exporter
wrote (and with a ``module.`` prefix and a ``state_dict`` wrapper),
``models/torch_export.py`` key for key and value for value at CP orders
2-5, ``models/clip_import.py`` on a seeded HuggingFace-layout CLIP dict
with both spellings of ``pre_layrnorm`` (through ``api.build_model`` and
merged serving too), and the ``.pt`` paths of ``cli.vit_cp --evaluate``,
``cli.export`` and ``Predictor.from_checkpoint_auto``.  Tiny models,
numpy trees from a seed, fp32; imports are exact, logits within
atol = rtol = 1e-4.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_torch_port_split import _arrays
from cara_tpu_torch import api as t_api
from cara_tpu_torch.cli import export as t_export
from cara_tpu_torch.cli import vit_cp as t_cli
from cara_tpu_torch.config import CaraConfig, get_model_config
from cara_tpu_torch.models import clip_import as t_clip
from cara_tpu_torch.models import convert
from cara_tpu_torch.models import torch_export as t_texp
from cara_tpu_torch.models import torch_import as t_timp
from cara_tpu_torch.serving import Predictor
from cara_tpu_torch.train import checkpoint as t_ckpt
from cara_tpu import config as j_config
from cara_tpu import serving as j_serving
from cara_tpu.cli import export as j_export
from cara_tpu.models import clip_import as j_clip
from cara_tpu.models import torch_export as j_texp
from cara_tpu.models import torch_import as j_timp

TOL = dict(atol=1e-4, rtol=1e-4)
MODEL = "vit_tiny_test"
# CLIP's geometry at the test model's width: ln_pre, quick_gelu, the
# visual projection.
CLIP_OVER = dict(image_size=28, patch_size=14, embed_dim=64, depth=2,
                 num_heads=4, repr_size=None, ln_pre=True,
                 activation="quick_gelu", proj_dim=48, layernorm_eps=1e-5,
                 drop_path_rate=0.0)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _trees(order, num_classes=10, seed=0):
    cfg = get_model_config(MODEL, num_classes=num_classes)
    cc = CaraConfig(rank=4, cp_order=order)
    params = convert.init_vit_params(cfg, seed)
    cara = convert.perturb_adapter(
        convert.init_cara_params(cfg, cc, seed + 1), seed + 2, std=0.05)
    return cfg, params, cara


@pytest.mark.parametrize("order", [2, 3, 4, 5])
def test_torch_export_matches_jax_key_for_key(order, tmp_path):
    """The state dict (fp32, timm keys, ``CP_*``) equals JAX's; the file
    both write loads to the same tensors."""
    cfg, params, cara = _trees(order)
    j_cfg = j_config.get_model_config(MODEL, num_classes=10)
    got = t_texp.to_torch_state_dict(convert.params_from_numpy(params, "cpu"),
                                     cara, cfg, order)
    want = j_texp.to_torch_state_dict(params, cara, j_cfg, order)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    t_path, j_path = str(tmp_path / "t.pt"), str(tmp_path / "j.pt")
    t_texp.save_torch_checkpoint(t_path, params, cara, cfg, order)
    j_texp.save_torch_checkpoint(j_path, params, cara, j_cfg, order)
    t_sd = torch.load(t_path, weights_only=True)
    j_sd = torch.load(j_path, weights_only=True)
    assert list(t_sd) == list(j_sd)
    for k in j_sd:
        assert torch.equal(t_sd[k], j_sd[k]), k
    with pytest.raises(ValueError, match="not a plain CP factor set"):
        t_texp.to_torch_state_dict(params, {"qkv": {"a": 0}}, cfg, order)


@pytest.mark.parametrize("order", [2, 3, 4, 5])
def test_torch_import_of_jax_export_matches_jax(order, tmp_path):
    """A ``.pt`` that ``cara_tpu``'s exporter wrote loads to JAX's import,
    exactly; a ``module.`` prefix and a ``{"state_dict": ...}`` wrapper
    load the same."""
    cfg, params, cara = _trees(order)
    j_cfg = j_config.get_model_config(MODEL, num_classes=10)
    path = str(tmp_path / "ref.pt")
    j_texp.save_torch_checkpoint(path, params, cara, j_cfg, order)
    assert t_timp.is_torch_checkpoint(path)
    got = t_timp.load_torch_checkpoint(path, cfg)
    want = j_timp.load_torch_checkpoint(path, j_cfg)
    _assert_trees_equal(got[0], want[0])
    _assert_trees_equal(got[1], want[1])
    assert got[2] == want[2] == {"cp_order": order, "rank": 4}
    _assert_trees_equal(got[1], cara)
    sd = torch.load(path, weights_only=True)
    wrapped = str(tmp_path / "wrapped.pt")
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}},
               wrapped)
    again = t_timp.load_torch_checkpoint(wrapped, cfg)
    _assert_trees_equal(again[0], got[0])
    _assert_trees_equal(again[1], got[1])


def _hf_clip_dict(cfg, seed, spelling="pre_layrnorm"):
    """A seeded ``CLIPVisionModelWithProjection`` state dict for ``cfg``
    (torch tensors, the HF key names)."""
    e, hid, p = cfg.embed_dim, cfg.hidden_dim, cfg.patch_size
    vm = "vision_model."
    shapes = {vm + "embeddings.class_embedding": (e,),
              vm + "embeddings.patch_embedding.weight": (e, 3, p, p),
              vm + "embeddings.position_embedding.weight": (cfg.seq_len, e),
              vm + f"{spelling}.weight": (e,), vm + f"{spelling}.bias": (e,),
              vm + "post_layernorm.weight": (e,),
              vm + "post_layernorm.bias": (e,),
              "visual_projection.weight": (cfg.proj_dim, e)}
    for i in range(cfg.depth):
        pre = vm + f"encoder.layers.{i}."
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            shapes[pre + f"self_attn.{n}.weight"] = (e, e)
            shapes[pre + f"self_attn.{n}.bias"] = (e,)
        for n in ("layer_norm1", "layer_norm2"):
            shapes[pre + f"{n}.weight"] = (e,)
            shapes[pre + f"{n}.bias"] = (e,)
        shapes[pre + "mlp.fc1.weight"] = (hid, e)
        shapes[pre + "mlp.fc1.bias"] = (hid,)
        shapes[pre + "mlp.fc2.weight"] = (e, hid)
        shapes[pre + "mlp.fc2.bias"] = (e,)
    arrays = _arrays(seed, **{k: (s, 0.05) for k, s in shapes.items()})
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


@pytest.mark.parametrize("spelling", ["pre_layrnorm", "pre_layernorm"])
def test_torch_clip_import_matches_jax(spelling, tmp_path):
    """The HF key map against JAX's, exactly, with either spelling of the
    pre-LayerNorm; ``api.build_model(backbone_path=*.bin)`` routes through
    it and merged serving of the imported tower gives JAX's logits."""
    cfg = get_model_config(MODEL, **CLIP_OVER)
    j_cfg = j_config.get_model_config(MODEL, **CLIP_OVER)
    sd = _hf_clip_dict(cfg, 4, spelling)
    assert t_clip.is_clip_state_dict(sd)
    got = t_clip.convert_hf_clip_vision(sd, cfg)
    _assert_trees_equal(got, j_clip.convert_hf_clip_vision(sd, j_cfg))
    path = str(tmp_path / "clip_vision.bin")
    torch.save(sd, path)
    _assert_trees_equal(t_clip.load_clip_backbone(path, cfg), got)
    model = t_api.build_model(MODEL, rank=4, num_classes=5,
                              backbone_path=path, model_overrides=CLIP_OVER)
    assert model.params["head"]["kernel"].shape == (48, 5)
    np.testing.assert_array_equal(model.params["blocks"]["qkv"]["kernel"],
                                  got["blocks"]["qkv"]["kernel"])
    params = dict(got, head=model.params["head"])
    x = np.random.default_rng(1).standard_normal((3, 28, 28, 3)).astype(
        np.float32)
    t_cfg = dataclasses.replace(cfg, num_classes=5)
    out = Predictor(params, t_cfg, device="cpu", dtype=torch.float32,
                    batch_size=4).logits(x)
    ref = j_serving.Predictor(params, dataclasses.replace(j_cfg,
                                                          num_classes=5),
                              dtype=jnp.float32, batch_size=4).logits(x)
    np.testing.assert_allclose(out, ref, **TOL)
    with pytest.raises(ValueError, match="wrong --model geometry"):
        t_clip.convert_hf_clip_vision(sd, dataclasses.replace(
            cfg, patch_size=7))
    bad = str(tmp_path / "not_clip.pt")
    torch.save({"w": torch.zeros(2)}, bad)
    with pytest.raises(ValueError, match="HF CLIP vision"):
        t_clip.load_clip_backbone(bad, cfg)


def _pt_checkpoint(tmp_path, order=4):
    # Order 4: an npz's --evaluate takes the CLI's adapter config (JAX's
    # too), a .pt's rank and order come from the file.
    """A reference ``.pt`` of a 2-class adapter (patch_camelyon) and the
    npz of the same weights."""
    cfg, params, cara = _trees(order, num_classes=2, seed=5)
    npz = str(tmp_path / "vit_patch_camelyon.npz")
    t_ckpt.save_model(npz, params, cara, {"model": MODEL, "scale": 0.1,
                                          "cp_order": order})
    pt = str(tmp_path / "vit_patch_camelyon.pt")
    j_texp.save_torch_checkpoint(pt, params, cara, j_config.get_model_config(
        MODEL, num_classes=2), order)
    return npz, pt


def test_torch_pt_paths_of_the_clis_and_predictor(tmp_path):
    """``--evaluate X.pt`` (rank and order from the file, the scale from
    the task table) gives the npz's accuracy, merged too; ``cli.export``
    takes the ``.pt`` (merged, as JAX's export of it) and writes one
    (``--mode torch``, as JAX's); ``Predictor.from_checkpoint_auto``
    serves a ``.pt`` with ``scale`` as JAX's does, and refuses it
    without."""
    npz, pt = _pt_checkpoint(tmp_path)
    argv = ["--synthetic", "--dataset", "patch_camelyon", "--model", MODEL,
            "--batch-size", "8", "--eval-batch-size", "8",
            "--synthetic-size", "16", "--dtype", "float32", "--backbone",
            str(tmp_path / "none.npz"), "--out-dir", str(tmp_path),
            "--dim", "4", "--device", "cpu", "--evaluate"]
    acc_pt = t_cli.main(argv + [pt])
    assert acc_pt == pytest.approx(t_cli.main(
        argv + [npz, "--merged-eval"]), abs=1e-6)
    assert t_cli.main(argv + [pt, "--merged-eval"]) == pytest.approx(
        acc_pt, abs=1e-6)

    out = {}
    for name, main, extra in (("t", t_export.main, ["--device", "cpu"]),
                              ("j", j_export.main, [])):
        out[name] = str(tmp_path / f"{name}_merged.npz")
        main(["--ckpt", pt, "--model", MODEL, "--scale", "0.1", "--out",
              out[name], "--mode", "merged", *extra])
    got, meta = t_ckpt.load_model(out["t"])[0::2]
    want, j_meta = t_ckpt.load_model(out["j"])[0::2]
    assert meta == j_meta and meta["cp_order"] == 4
    for k, v in _flat(want).items():
        np.testing.assert_allclose(_flat(got)[k], v, atol=1e-6, err_msg=k)
    with pytest.raises(SystemExit, match="needs --model"):
        t_export.main(["--ckpt", pt, "--out", str(tmp_path / "x.npz")])
    for name, main in (("t", t_export.main), ("j", j_export.main)):
        out[name] = str(tmp_path / f"{name}.pt")
        main(["--ckpt", npz, "--out", out[name], "--mode", "torch"])
    t_sd = torch.load(out["t"], weights_only=True)
    j_sd = torch.load(out["j"], weights_only=True)
    assert list(t_sd) == list(j_sd) and "CP_A3" in t_sd
    for k in j_sd:
        assert torch.equal(t_sd[k], j_sd[k]), k

    x = np.random.default_rng(2).standard_normal((3, 32, 32, 3)).astype(
        np.float32)
    port = Predictor.from_checkpoint_auto(
        pt, MODEL, scale=0.1, merge=False, device="cpu", dtype=torch.float32,
        batch_size=4)
    ref = j_serving.Predictor.from_checkpoint_auto(
        pt, MODEL, scale=0.1, merge=False, dtype=jnp.float32, batch_size=4)
    np.testing.assert_allclose(port.logits(x), ref.logits(x), **TOL)
    with pytest.raises(ValueError, match="no delta scale"):
        Predictor.from_checkpoint_auto(pt, MODEL, device="cpu")
