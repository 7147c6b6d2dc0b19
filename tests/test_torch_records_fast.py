"""The port's ``fast-scan --skip-acceptance`` and ``rescore-fast-scan``
(``scripts/torch_validation_records.py``) against the JAX scripts
``scripts/fast_scan_acceptance.py`` and
``scripts/rescore_fast_scan_validation.py``, run in process through
``click.testing.CliRunner`` on the CPU, on one tiny assembled folder: a
16^3 CatPhan (``--phantom-shape 16``), 2 views at the production panel
(1848 x 768), their (primary, total) images made from a seed.

Every statistic key of both records is held within rtol 1e-5, the
tolerance ``tests/test_torch_primary.py`` holds the deterministic primary
to (XLA fuses ``a * b + c`` into an FMA on the CPU, the port does not); the
superpixel counts and the view indices exactly. The fast stack's draws come
from another stream (a ``torch.Generator``), so only its shape, its
finiteness and the primary it was composed around are checked.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from test_torch_boundary import REPO
from test_torch_records_chain import _invoke, _load, records

torch.set_num_threads(2)

N_VIEWS, PHANTOM, N_MC = 2, 16, 2e4


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """The same folder twice, one for each package (both write into it)."""
    root = tmp_path_factory.mktemp("fast")
    theirs = root / "jax"
    theirs.mkdir()
    rng = np.random.default_rng(7)
    v, u = 768, 1848
    fan = np.exp(-((np.arange(u) - 700.0) / 600.0) ** 2)[None, :] * np.ones((v, 1))
    images = np.stack([np.stack([fan * 1e-2, fan * 1.3e-2])
                       * (1.0 + 0.1 * rng.standard_normal((2, v, u)))
                       for _ in range(N_VIEWS)]).astype(np.float32)
    np.save(theirs / "images.npy", np.maximum(images, 0.0))
    np.save(theirs / "air.npy", np.full((2, v, u), 2e-2, np.float32))
    np.save(theirs / "angle_indices.npy", np.arange(N_VIEWS))
    np.save(theirs / "order.npy", np.arange(N_VIEWS))
    ours = root / "port"
    shutil.copytree(theirs, ours)
    return root, theirs, ours


def test_fast_scan_matches_the_jax_script(folders):
    root, theirs, ours = folders
    jscript = _load("fast_scan_acceptance", REPO / "scripts" / "fast_scan_acceptance.py")
    args = ["--n-histories-mc", N_MC, "--phantom-shape", PHANTOM, "--skip-acceptance"]
    _invoke(jscript.main, ["--folder", theirs, *args])
    _invoke(records.cli, ["fast-scan", "--device", "cpu", "--folder", ours, *args,
                          "--output", root / "fast.json"])
    jax = json.loads((theirs / "fast_scan_validation.json").read_text())
    plain = json.loads((ours / "fast_scan_validation.json").read_text())
    record = json.loads((root / "fast.json").read_text())
    assert plain.keys() == jax.keys()
    for key, value in jax.items():
        if key == "seconds_per_view":
            continue
        assert plain[key] == pytest.approx(value, rel=1e-5), key
        assert record[key] == plain[key], key
    assert record["relative_mask"]["n_superpixels"] > 0
    fast = np.load(ours / "images_fast.npy")
    assert fast.shape == (N_VIEWS, 2, 768, 1848) and np.isfinite(fast).all()
    assert (fast >= 0).all() and (fast[:, 1] >= fast[:, 0]).all()


def test_rescore_matches_the_jax_script(folders):
    root, theirs, ours = folders
    jscript = _load("rescore_fast_scan_validation",
                    REPO / "scripts" / "rescore_fast_scan_validation.py")
    args = ["--n-views", N_VIEWS, "--n-histories-mc", N_MC, "--phantom-shape", PHANTOM]
    _invoke(jscript.main, ["--folder", theirs, *args, "--output", root / "jax_rescored.json"])
    _invoke(records.cli, ["rescore-fast-scan", "--device", "cpu", "--folder", ours, *args,
                          "--output", root / "rescored.json"])
    jax = json.loads((root / "jax_rescored.json").read_text())
    ours_ = json.loads((root / "rescored.json").read_text())
    for key, value in jax.items():
        if key == "platform":
            continue
        if isinstance(value, (int, list)):
            assert ours_[key] == value, key
        else:
            assert ours_[key] == pytest.approx(value, rel=1e-5), key
    # the fast scan's relative mask over the same views is the rescore's
    fast = json.loads((root / "fast.json").read_text())["relative_mask"]
    for key, value in fast.items():
        assert ours_[key] == pytest.approx(value, rel=1e-12), key
