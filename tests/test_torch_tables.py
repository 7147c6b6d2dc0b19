"""The port's physics tables against the JAX package's: every field of
DeviceTables / WoodcockTable is bit-equal (the port runs its own copies of
the numpy builders), interop carries JAX arrays across unchanged, the
Chebyshev sigma evaluation agrees, and the copied assets are byte-identical."""

import hashlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbctmc_tpu.engine import tables as jtables
from cbctmc_tpu.physics.materials import default_material_set as jax_material_set
from cbctmc_tpu.physics.spectrum import default_spectrum as jax_spectrum
from cbctmc_tpu_torch import interop
from cbctmc_tpu_torch.engine import tables as ttables
from cbctmc_tpu_torch.physics.materials import default_material_set
from cbctmc_tpu_torch.physics.spectrum import default_spectrum

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
ASSETS = sorted(p.name for p in (ROOT / "cbctmc_tpu_torch" / "assets").glob("*.npz"))


@pytest.fixture(scope="module")
def table_set():
    return default_material_set()


@pytest.fixture(scope="module")
def jax_tables():
    return jtables.build_device_tables(jax_material_set(), jax_spectrum())


@pytest.fixture(scope="module")
def port_tables(table_set):
    return ttables.build_device_tables(table_set, default_spectrum(), device="cpu")


def _scene_max_density(table_set):
    """A CatPhan-like max-density vector with a soft tier (inserts heavy)."""
    max_density = np.zeros(table_set.n_materials, np.float32)
    soft = np.zeros(table_set.n_materials, np.float32)
    for name in ("air", "h2o", "teflon", "delrin", "bone_050", "ldpe"):
        m = table_set.material(name)
        max_density[m.index] = m.density
        if name in ("air", "h2o", "ldpe"):
            soft[m.index] = m.density
    return max_density, soft


def _same(port: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    got = port.numpy()
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("field", ttables.DeviceTables._fields)
def test_device_table_field_bit_equal(jax_tables, port_tables, field):
    _same(getattr(port_tables, field), getattr(jax_tables, field))


@pytest.fixture(scope="module")
def woodcocks(table_set):
    max_density, soft = _scene_max_density(table_set)
    return (
        jtables.build_woodcock_table(jax_material_set(), max_density, soft),
        ttables.build_woodcock_table(table_set, max_density, soft, device="cpu"),
    )


@pytest.mark.parametrize("field", ttables.WoodcockTable._fields)
def test_woodcock_field_bit_equal(woodcocks, field):
    jw, tw = woodcocks
    _same(getattr(tw, field), getattr(jw, field))


def test_interop_carries_jax_tables(jax_tables, woodcocks):
    fields = {k: np.asarray(v) for k, v in jax_tables._asdict().items()}
    carried = interop.tables_from_numpy(fields, device="cpu")
    for k in ttables.DeviceTables._fields:
        _same(getattr(carried, k), fields[k])
    jw, _ = woodcocks
    wc = interop.woodcock_from_numpy(
        {k: np.asarray(v) for k, v in jw._asdict().items()}, device="cpu"
    )
    for k in ttables.WoodcockTable._fields:
        _same(getattr(wc, k), getattr(jw, k))


def test_sigma_coeff_rows_equal(jax_tables, port_tables):
    _same(ttables.sigma_coeff_table(port_tables), jtables.sigma_coeff_table(jax_tables))


def test_eval_sigma_partials_matches_jax(jax_tables, port_tables):
    """Same energies and materials: the indexed row + [n, 3] Clenshaw
    recurrence against the JAX one-hot fetch + per-channel loop. Tolerance
    1e-5 relative: the two libraries' float32 log(E) may differ by an ulp
    (~1e-6 of log E ~ 11), which moves s and, through d(log sigma)/ds of a
    few units, the result by a few 1e-6."""
    rng = np.random.default_rng(0)
    n = 4096
    n_mats = port_tables.n_mats
    energy = rng.uniform(5_000.0, 125_000.0, n).astype(np.float32)
    mat = rng.integers(0, n_mats, n).astype(np.int32)
    onehot = (mat[:, None] == np.arange(n_mats)[None, :]).astype(np.float32)
    ref = jtables.eval_sigma_partials(jax_tables, jnp.asarray(energy), jnp.asarray(onehot))
    got = ttables.eval_sigma_partials(
        port_tables, torch.from_numpy(energy), torch.from_numpy(mat)
    )
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5)


@pytest.mark.parametrize("name", ASSETS)
def test_asset_byte_identical(name):
    def sha(p):
        return hashlib.sha256(p.read_bytes()).hexdigest()

    assert sha(ROOT / "cbctmc_tpu_torch" / "assets" / name) == sha(
        ROOT / "cbctmc_tpu" / "assets" / name
    )


def test_assets_complete():
    assert set(ASSETS) == {
        "atomic_data.npz",
        "materials_125kev.npz",
        "bowtie_filters.npz",
        "spectrum_125kVp_0.89mmTi.npz",
        "spectrum_125kVp_0.89mmTi_half_bowtie_varian_norm.npz",
        "spectrum_125kVp_0.89mmTi_varian_norm.npz",
        "spectrum_125kVp_varian_norm.npz",
    }
