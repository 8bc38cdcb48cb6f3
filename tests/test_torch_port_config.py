"""The port's config registry agrees with the JAX package's, and the port
imports without JAX."""

import dataclasses
import os
import subprocess
import sys

import pytest

from cara_tpu_torch import config as t_config
from cara_tpu_torch.models import cara as t_cara
from cara_tpu import config as j_config
from cara_tpu.models import cara as j_cara

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_model_registries_agree():
    assert sorted(t_config.MODEL_REGISTRY) == sorted(j_config.MODEL_REGISTRY)
    for name in j_config.MODEL_REGISTRY:
        t_cfg = t_config.get_model_config(name)
        j_cfg = j_config.get_model_config(name)
        assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg), name
        for prop in ("head_dim", "hidden_dim", "grid_size", "seq_len"):
            assert getattr(t_cfg, prop) == getattr(j_cfg, prop), (name, prop)
    over = t_config.get_model_config("vit_tiny_test", depth=3)
    assert over.depth == 3
    with pytest.raises(ValueError, match="Unknown model"):
        t_config.get_model_config("no_such_model")


@pytest.mark.parametrize("order", [3, 4, 5])
def test_cara_config_and_shapes_agree(order):
    t_cc = t_config.CaraConfig(rank=8, cp_order=order)
    j_cc = j_config.CaraConfig(rank=8, cp_order=order)
    assert dataclasses.asdict(t_cc) == dataclasses.asdict(j_cc)
    assert t_config.CaraConfig.METHODS == j_config.CaraConfig.METHODS
    model_t = t_config.get_model_config("vit_base_patch16_224_in21k")
    model_j = j_config.get_model_config("vit_base_patch16_224_in21k")
    assert (t_cara.cara_param_shapes(model_t, t_cc)
            == j_cara.cara_param_shapes(model_j, j_cc))
    assert (t_cc.trainable_param_count(model_t)
            == j_cc.trainable_param_count(model_j))
    with pytest.raises(ValueError):
        t_config.CaraConfig(method="nope")


def test_port_imports_without_jax():
    modules = [
        "cara_tpu_torch", "cara_tpu_torch.config", "cara_tpu_torch.ops.cp",
        "cara_tpu_torch.ops.layers", "cara_tpu_torch.ops.cuda._build",
        "cara_tpu_torch.ops.cuda._site",
        "cara_tpu_torch.ops.cuda.fused_qkv_attention",
        "cara_tpu_torch.ops.cuda.cp_attn_block",
        "cara_tpu_torch.ops.cuda.cp_mlp", "cara_tpu_torch.models.cara",
        "cara_tpu_torch.models.convert", "cara_tpu_torch.models.merge",
        "cara_tpu_torch.models.vit", "cara_tpu_torch.train.checkpoint",
        "cara_tpu_torch.data.vtab", "cara_tpu_torch.serving",
        "cara_tpu_torch.server", "cara_tpu_torch.cli.serve", "chip_smoke"]
    code = (
        "import importlib, pkgutil, sys\n"
        f"mods = {modules!r}\n"
        "import cara_tpu_torch\n"
        "mods += [m.name for m in pkgutil.walk_packages(\n"
        "    cara_tpu_torch.__path__, 'cara_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'cara_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(set(mods)))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.strip()) >= len(modules)


def _roadmap_items():
    """queue number -> normalized bold titles of ``ROADMAP.md``'s queues
    ("### N. ..." sections, items "N. **Title** ...", a title may wrap)."""
    import re

    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        text = f.read()
    items = {}
    for sec in re.split(r"^### ", text, flags=re.M)[1:]:
        head = re.match(r"(\d+)\. ", sec)
        if head:
            items[int(head.group(1))] = [
                _norm(" ".join(t.split())) for t in
                re.findall(r"^\d+\. \*\*(.+?)\*\*", sec, flags=re.M | re.S)]
    return items


def _norm(title):
    return title.replace("`", "").strip().rstrip(".").strip().lower()


def test_port_roadmap_references_name_roadmap_items():
    """Every ``ROADMAP.md queue N: <title>`` string in the port names an
    item of that queue: the title (up to ")", ";" or ",") begins the
    item's bold title at a word boundary."""
    import ast
    import re

    items = _roadmap_items()
    refs = []
    for root, _, files in os.walk(os.path.join(REPO, "cara_tpu_torch")):
        for name in sorted(files):
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            with open(path) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Constant) and isinstance(node.value,
                                                                 str):
                    for m in re.finditer(r"ROADMAP\.md queue (\d+): "
                                         r"([^);,]+)", node.value):
                        refs.append((path, int(m.group(1)), m.group(2)))
    assert len(refs) >= 10
    for path, queue, title in refs:
        want = _norm(title)
        ok = any(t.startswith(want) and not t[len(want):len(want) + 1]
                 .isalnum() for t in items.get(queue, []))
        assert ok, (f"{os.path.relpath(path, REPO)} names {title!r} in "
                    f"ROADMAP.md queue {queue}, which holds "
                    f"{items.get(queue)}")
