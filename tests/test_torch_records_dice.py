"""The port's ``segmenter-dice`` (``scripts/torch_validation_records.py``)
against the JAX ``MCSegmenter`` with the packaged flax weights, on the CPU:
``generate_case(9000)`` at its own shape (144, 112, 96), the first case of
``docs/validation/segmenter_eval_r4.json`` (the port's generator is the JAX
script's, bit-equal: ``tests/test_torch_datasets.py``), patches of 64^3
with overlap 0.25, each label's Dice as ``scripts/eval_segmenter_asset.py``
counts it (the script's main, which publishes into the JAX package's
assets, is never run).

Tolerance: each label's Dice within 1e-3 of JAX's and the mean foreground
Dice within 1e-3. The nets agree within 1e-4 of their probabilities
(``tests/test_torch_models.py``), so only a voxel whose two top classes
tie within that can land on another label. The JAX package on the CPU
reads liver 0.123385 and a foreground mean of 0.700768 on this case, the
record (made by the script, whose default is the TPU) liver 0.511725; the
port reads the JAX package's values, so the record itself is not held
here (the record's items are compared and written, and miss). Also: the
gate's verdict and its publication only under ``--asset-dir`` (a
package's assets refused), and the evaluation seeds refused below 2000 as
the script does.
"""

import hashlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from cbctmc_tpu.models.checkpoints import load_params as jload_params
from cbctmc_tpu.models.segmentation import LABELS as JLABELS
from cbctmc_tpu.models.segmentation import N_SOFTMAX_LABELS as JN_SOFTMAX
from cbctmc_tpu.models.segmentation import MCSegmenter as JMCSegmenter
from cbctmc_tpu.models.segmentation import default_segmenter_model as jdefault_model

from test_torch_boundary import REPO
from test_torch_records_chain import _invoke, _load, records

torch.set_num_threads(2)

PORT_ASSETS = REPO / "cbctmc_tpu_torch" / "assets" / "models"
SHAPE = (144, 112, 96)  # generate_case's own


def _jax_dice(seed, shape=SHAPE):
    """eval_segmenter_asset.py's loop body for one volume."""
    gen = _load("generate_synthetic_ct", REPO / "scripts" / "generate_synthetic_ct.py")
    model = jdefault_model()
    template = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 32, 1)))["params"]
    segmenter = JMCSegmenter(model=model, params=jload_params(
        template, PORT_ASSETS / "segmenter" / "default.ckpt"), patch_shape=(64, 64, 64),
        patch_overlap=0.25)
    image, labels = gen.generate_case(seed=seed, shape=shape)
    pred, _ = segmenter.segment(image)
    pred = pred[:, : image.shape[0], : image.shape[1], : image.shape[2]]
    vol, dices = {}, []
    for li, name in JLABELS.items():
        p, g = pred[li] > 0.5, labels[li] > 0.5
        denom = p.sum() + g.sum()
        vol[name] = float(2.0 * np.logical_and(p, g).sum() / denom) if denom else 1.0
        if li > 0 and li != JN_SOFTMAX - 1:
            dices.append(vol[name])
    return vol, float(np.mean(dices))


def _sha_tree():
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in PORT_ASSETS.rglob("*") if p.is_file()}


def test_segmenter_dice_matches_jax(tmp_path):
    before = _sha_tree()
    _invoke(records.cli, [
        "segmenter-dice", "--device", "cpu", "--n-volumes", 1, "--seed0", 9000,
        "--min-dice", 0.0, "--output-dir", tmp_path / "eval",
        "--asset-dir", tmp_path / "asset", "--output", tmp_path / "record.json"])
    record = json.loads((tmp_path / "record.json").read_text())
    theirs, jmean = _jax_dice(9000)
    ours = record["per_volume"][0]
    assert ours.keys() == theirs.keys()
    for name in theirs:
        assert abs(ours[name] - theirs[name]) <= 1e-3, name
    assert abs(record["mean_foreground_dice"] - jmean) <= 1e-3
    # the gate (>= 0 passes) published the checkpoint under --asset-dir only
    assert record["quality_gate"]["passed"] and record["published"]
    assert ((tmp_path / "asset" / "default.ckpt").read_bytes()
            == (PORT_ASSETS / "segmenter" / "default.ckpt").read_bytes())
    stamp = json.loads((tmp_path / "asset" / "default.eval.json").read_text())
    assert stamp["mean_foreground_dice"] == record["mean_foreground_dice"]
    # the record's seed-9000 items are compared and written; the mean is the
    # record's only over its three seeds
    items = record["against_jax"]["items"]
    assert [it["item"] for it in items] == [f"seed 9000 {name} Dice" for name in theirs]
    assert _sha_tree() == before


@pytest.mark.parametrize("args,message", [
    (["--asset-dir", PORT_ASSETS / "segmenter"], "assets"),
    (["--asset-dir", REPO / "cbctmc_tpu" / "assets" / "models" / "segmenter"], "assets"),
    (["--seed0", 1000], "disjoint"),
])
def test_segmenter_dice_refusals(tmp_path, args, message):
    before = _sha_tree()
    result = CliRunner().invoke(records.cli, [str(a) for a in [
        "segmenter-dice", "--device", "cpu", "--n-volumes", 1,
        "--output-dir", tmp_path / "eval", "--output", tmp_path / "record.json", *args]])
    assert result.exit_code != 0 and message in result.output
    assert not (tmp_path / "record.json").exists() and _sha_tree() == before

