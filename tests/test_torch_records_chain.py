"""The CatPhan record chain of ``scripts/torch_validation_records.py`` on the
CPU: the ``catphan`` subcommand's folder in the JAX package's assembled
layout (``images.npy`` f32[P, 2, v, u] at the whole detector's width,
``air.npy``, ``angle_indices.npy``, ``order.npy``) on a 4-view rehearsal,
and the ``catphan`` acceptance and the ``mc-fp`` record from that stack
equal to those from its half-fan crop (the stack the records kept before):
every number equal, no tolerance. The speedup chain is in
``tests/test_torch_records_speedup.py``, the fast scan in
``tests/test_torch_records_fast.py``, the segmenter's Dice in
``tests/test_torch_records_dice.py``.
"""

import importlib.util
import json

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from test_torch_boundary import REPO

torch.set_num_threads(2)

DONOR = dict(views=4, histories=20_000, phantom=16)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


records = _load("torch_validation_records", REPO / "scripts" / "torch_validation_records.py")


def _invoke(command, args):
    result = CliRunner().invoke(command, [str(a) for a in args], catch_exceptions=False)
    assert result.exit_code == 0, result.output
    return result


# ---------------------------------------------------------------------------
# the donor folder's layout; the records from the whole width and the crop
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def donor(tmp_path_factory):
    folder = tmp_path_factory.mktemp("donor")
    out = folder / "catphan.json"
    _invoke(records.cli, [
        "catphan", "--device", "cpu", "--n-projections", DONOR["views"],
        "--n-histories", DONOR["histories"], "--air-histories", DONOR["histories"],
        "--phantom-shape", DONOR["phantom"], "--phantom-spacing", 500.0 / DONOR["phantom"],
        "--n-lanes", 4096, "--work-folder", folder / "run", "--output", out])
    return folder / "run", json.loads(out.read_text())


def test_catphan_folder_is_the_assembled_layout(donor):
    folder, record = donor
    images = np.load(folder / "images.npy")
    assert images.dtype == np.float32 and images.shape == (DONOR["views"], 2, 768, 1848)
    assert np.load(folder / "air.npy").shape == (2, 768, 1848)
    np.testing.assert_array_equal(np.load(folder / "angle_indices.npy"),
                                  np.arange(DONOR["views"]))
    np.testing.assert_array_equal(np.load(folder / "order.npy"),
                                  records.interleaved_order(DONOR["views"]))
    assert not (folder / "images.partial.npy").exists()
    # every view simulated, primary below total, columns past the crop kept
    assert (images[:, 0] <= images[:, 1] + 1e-12).all()
    assert (images.reshape(DONOR["views"], -1).max(axis=1) > 0).all()
    assert images[..., 1024:].max() > 0
    assert set(record["walls_s"]) >= {"setup", "air_flat", "scan", "save_stack", "acceptance"}


def _same_tree(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    else:
        assert a == b or (a != a and b != b), (a, b)


def test_catphan_acceptance_from_the_whole_width_equals_its_crop(donor):
    folder, record = donor
    images = np.load(folder / "images.npy", mmap_mode="r")
    air = np.load(folder / "air.npy")
    angles = records.mc_scan_angles(DONOR["views"])
    # a thin grid: the two stacks must reach every FDK with the same values
    whole, _, vw = records.catphan_acceptance(images, air, angles, n_histories=2e4,
                                              grid_shape=(256, 256, 12), device="cpu")
    crop, _, vc = records.catphan_acceptance(np.ascontiguousarray(images[..., :1024]),
                                             air[..., :1024], angles, n_histories=2e4,
                                             grid_shape=(256, 256, 12), device="cpu")
    _same_tree(whole, crop)
    for name in vw:
        np.testing.assert_array_equal(vw[name], vc[name])
    assert np.isfinite(record["total_own_wpc"]["mean_absolute_relative_error"])


def test_mc_fp_from_the_whole_width_equals_its_crop(donor, tmp_path):
    folder, _ = donor
    cropped = tmp_path / "cropped"
    cropped.mkdir()
    np.save(cropped / "images.npy", np.load(folder / "images.npy")[..., :1024])
    np.save(cropped / "air.npy", np.load(folder / "air.npy"))
    out = {}
    for name, f in (("whole", folder), ("crop", cropped)):
        _invoke(records.cli, ["mc-fp", "--device", "cpu", "--folder", f, "--n-views", 2,
                              "--phantom-shape", DONOR["phantom"],
                              "--output", tmp_path / f"{name}.json"])
        out[name] = json.loads((tmp_path / f"{name}.json").read_text())
        del out[name]["walls_s"]
    _same_tree(out["whole"], out["crop"])
