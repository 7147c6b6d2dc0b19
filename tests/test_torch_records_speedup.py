"""The speedup chain of ``scripts/torch_validation_records.py`` on the CPU,
against the JAX package:

- the forward-projection guidance against the JAX ``project_forward`` with
  the scripts' binning, repeat and flip (within 1e-5 of the projection's
  max: XLA fuses ``a * b + c`` into an FMA on the CPU, the port does not, as
  ``tests/test_torch_joseph.py`` holds);
- ``train-speedup`` at toy size: the holdout split (``i % 8 == 7``), the
  triplets bit-equal to their sources, PSNR by the script's formula
  (``scripts/train_speedup_from_catphan.py:146-148``, peak: the reference's
  max), the best checkpoint by holdout kept and evaluated, and publication
  only under ``--asset-dir`` (a package's assets refused);
- ``scripts/speedup_acceptance.py --n-low 0 --skip-acceptance`` with the
  packaged checkpoint against the port's ``speedup-acceptance`` on one
  small-detector folder: the guidance within 1e-5 of its max, the ``mean``
  stack within 1e-4 of its max (the nets agree within 1e-4,
  ``tests/test_torch_models.py``); the ``sample`` stack is drawn from
  another stream (a ``torch.Generator``), so only its primary channel and
  its finiteness are compared.
"""

import hashlib
import json
import shutil

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from cbctmc_tpu.geometry.phantoms import CatPhan604Geometry as JCatPhan
from cbctmc_tpu.recon.geometry import ConeBeamGeometry as JConeBeamGeometry
from cbctmc_tpu.recon.joseph import project_forward as jproject_forward

from test_torch_boundary import REPO
from test_torch_records_chain import _invoke, _load, records

torch.set_num_threads(2)

PORT_ASSETS = REPO / "cbctmc_tpu_torch" / "assets" / "models"


def _sha(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


def _script_psnr(a, b):
    mse = float(np.mean((a - b) ** 2))
    return 10.0 * np.log10(float(b.max()) ** 2 / max(mse, 1e-30))


def small_folder(folder, n_views=16, v=64, u=128, seed=0):
    """An assembled folder of ``n_views`` views on a v x u panel: smooth
    (primary, total) projections with 5 % noise, the air flat and the
    angles (the scripts read only these files)."""
    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    base = np.exp(-((np.arange(u) - 0.45 * u) / (0.3 * u)) ** 2)[None, :] * np.ones((v, 1))
    images = np.stack([np.stack([base * 3e-3, base * 4e-3])
                       * (1.0 + 0.05 * rng.standard_normal((2, v, u)))
                       for _ in range(n_views)]).astype(np.float32)
    np.save(folder / "images.npy", images)
    np.save(folder / "air.npy", np.stack([np.full((v, u), 5e-3), np.full((v, u), 5.5e-3)])
            .astype(np.float32))
    np.save(folder / "angle_indices.npy", np.arange(n_views))
    np.save(folder / "order.npy", np.arange(n_views))
    return images



def _jax_guidance(phantom, angles, h, w):
    sp = 500.0 / phantom
    ph = JCatPhan(shape=(phantom,) * 3, image_spacing=(sp,) * 3)
    dens = np.ascontiguousarray(np.rot90(ph.densities, k=3, axes=(0, 1)))
    cb = JConeBeamGeometry(n_pixels_u=w // 4, n_pixels_v=h // 4,
                           pixel_size_u=717.024 / 1848 * 4, pixel_size_v=297.984 / 768 * 4,
                           detector_offset_u=0.0)
    fp = np.asarray(jproject_forward(dens, cb, angles, volume_spacing=(sp,) * 3,
                                     step_mm=2.0 * sp))
    return np.repeat(np.repeat(fp, 4, axis=1), 4, axis=2)[:, ::-1, :]


@pytest.mark.parametrize("phantom,h,w", [(16, 64, 128), (20, 66, 130)])
def test_forward_guidance_matches_jax(tmp_path, phantom, h, w):
    angles = records.acceptance_angles(np.arange(0, 70, 7), 70)  # 10 views over 2 chunks
    records.FP_CHUNK, chunk = 4, records.FP_CHUNK
    try:
        records.forward_guidance(phantom, angles, h, w, tmp_path / "fp.npy", "cpu")
    finally:
        records.FP_CHUNK = chunk
    ours = np.load(tmp_path / "fp.npy")
    theirs = _jax_guidance(phantom, angles, h, w)
    assert ours.shape == theirs.shape == (10, h // 4 * 4, w // 4 * 4)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5 * float(theirs.max()))
    assert not (tmp_path / "fp.partial.npy").exists()


def test_train_speedup_split_selection_and_publication(tmp_path, monkeypatch):
    from cbctmc_tpu_torch.pipeline import training_workflows

    folder, out = tmp_path / "run", tmp_path / "speedup"
    images = small_folder(folder, n_views=16)
    out.mkdir()
    low = (images[:, 1] * (1.0 + 0.2 * np.random.default_rng(1).standard_normal(
        images[:, 1].shape))).astype(np.float32)
    np.save(out / "low.npy", low)  # the low scan is not run again where it exists
    before = {p: _sha(p) for p in PORT_ASSETS.rglob("*") if p.is_file()}
    args = ["train-speedup", "--device", "cpu", "--catphan-folder", folder,
            "--output-folder", out, "--train-steps", 4, "--pretrain-steps", 2,
            "--batch-size", 1, "--patch", 32, "--eval-every", 1, "--phantom-shape", 16]

    # a package's assets are refused before anything runs
    refused = CliRunner().invoke(records.cli, [str(a) for a in args + [
        "--asset-dir", PORT_ASSETS / "speedup", "--output", tmp_path / "no.json"]])
    assert refused.exit_code != 0 and "assets" in refused.output
    assert not (tmp_path / "no.json").exists()

    # a passing gate, so that publication runs
    monkeypatch.setattr(training_workflows, "speedup_gate", lambda r: (True, "test gate"))
    _invoke(records.cli, args + ["--asset-dir", tmp_path / "asset",
                                 "--output", tmp_path / "record.json"])
    record = json.loads((tmp_path / "record.json").read_text())

    holdout = sorted(p.name[:-8] for p in (out / "holdout").glob("*_low.npy"))
    train = sorted(p.name[:-8] for p in (out / "triplets").glob("*_low.npy"))
    assert holdout == ["catphan_007", "catphan_015"]
    assert train == [f"catphan_{i:03d}" for i in range(16) if i % 8 != 7]
    fp = np.load(out / "fp.npy")
    for stem, i in (("catphan_007", 7), ("catphan_003", 3)):
        d = out / ("holdout" if i % 8 == 7 else "triplets")
        np.testing.assert_array_equal(np.load(d / f"{stem}_low.npy"), low[i])
        np.testing.assert_array_equal(np.load(d / f"{stem}_high.npy"), images[i, 1])
        np.testing.assert_array_equal(np.load(d / f"{stem}_fp.npy"), fp[i])
    # PSNR is the script's
    for stem in holdout:
        lo, hi = (np.load(out / "holdout" / f"{stem}_{k}.npy") for k in ("low", "high"))
        assert record["holdout"][stem]["psnr_low"] == pytest.approx(
            _script_psnr(lo, hi), rel=1e-12)
    # the best step by the holdout gain is the one kept and evaluated
    gains = {int(k): v for k, v in record["holdout_gain_by_step"].items()}
    assert sorted(gains) == [1, 2, 3, 4]
    assert record["selected_step"] == max(gains, key=gains.get)
    assert (out / "train" / "best.ckpt").is_file()
    # published under --asset-dir only, the packages' assets untouched
    assert record["published"] and record["quality_gate"]["passed"]
    assert _sha(tmp_path / "asset" / "default.ckpt") == _sha(out / "train" / "best.ckpt")
    stamp = json.loads((tmp_path / "asset" / "default.eval.json").read_text())
    assert stamp["mean_psnr_gain_db"] == record["mean_psnr_gain_db"]
    assert {p: _sha(p) for p in PORT_ASSETS.rglob("*") if p.is_file()} == before


def test_speedup_acceptance_matches_the_jax_script(tmp_path):
    jscript = _load("speedup_acceptance", REPO / "scripts" / "speedup_acceptance.py")
    ckpt = PORT_ASSETS / "speedup" / "default.ckpt"
    theirs, ours = tmp_path / "jax", tmp_path / "port"
    small_folder(theirs, n_views=4)
    shutil.copytree(theirs, ours)
    common = ["--n-low", 0, "--skip-acceptance", "--checkpoint", ckpt, "--phantom-size", 16,
              "--batch-size", 2]
    _invoke(jscript.main, ["--folder", theirs, "--n-histories", 1.2e8, *common])
    _invoke(records.cli, ["speedup-acceptance", "--device", "cpu", "--folder", ours, *common,
                          "--output", tmp_path / "record.json"])
    gj, go = np.load(theirs / "fp_guidance.npy"), np.load(ours / "fp_guidance.npy")
    np.testing.assert_allclose(go, gj, rtol=0, atol=1e-5 * float(gj.max()))
    mj, mo = np.load(theirs / "images_speedup_mean.npy"), np.load(ours / "images_speedup_mean.npy")
    assert mo.shape == mj.shape == (4, 2, 64, 128)
    np.testing.assert_array_equal(mo[:, 0], mj[:, 0])
    np.testing.assert_allclose(mo[:, 1], mj[:, 1], rtol=0, atol=1e-4 * float(mj[:, 1].max()))
    so = np.load(ours / "images_speedup_sample.npy")
    np.testing.assert_array_equal(so[:, 0], mj[:, 0])
    assert np.isfinite(so).all() and (so[:, 1] >= 0).all()
    summary = json.loads((ours / "speedup_acceptance_summary.json").read_text())
    assert summary == {**json.loads((theirs / "speedup_acceptance_summary.json").read_text()),
                       "checkpoint": "cbctmc_tpu_torch/assets/models/speedup/default.ckpt"}
    record = json.loads((tmp_path / "record.json").read_text())
    assert record["checks"]["all_within"]
