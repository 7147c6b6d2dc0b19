"""The port's material-file generator against the JAX package's, on the CPU.

Every function of ``physics/material_generator.py`` is float64 numpy and
scipy in both packages, copied operation for operation, so the port is
held bit-equal on the same seeded inputs: arrays with ``np.array_equal``,
the written ``.mcgpu`` files character for character, and each package's
parser reads the other's file to the same float32 tables. The last test
runs the port's engine on a slab whose water came from ``generate_material``
against the JAX engine's channel sums with the same tables, at the
statistical bound of tests/test_torch_transport.py (the mean of 4 seeds
within 4 combined standard errors)."""

import dataclasses
import sys

import numpy as np
import pytest
import torch

from cbctmc_tpu.physics import material_generator as jgen
from cbctmc_tpu.physics import materials as jmaterials
from cbctmc_tpu_torch import interop
from cbctmc_tpu_torch.physics import material_generator as tgen
from cbctmc_tpu_torch.physics import materials as tmaterials

torch.set_num_threads(2)

FORMULAS = ["H2O", "C5H8O2", "CaCO3", "C2F4", "Al", "H0.5C1.5"]
ELEMENTS = [1, 6, 8, 9, 11, 13, 20, 26]


def fake_mu(z, energies, kind):
    """tests/test_material_generator.py's synthetic attenuation source."""
    e = np.asarray(energies, np.float64)
    base = {"coh": 0.1, "incoh": 0.15, "photo": 3.0, "total": 0.0}[kind]
    if kind == "photo":
        return base * z * (30_000.0 / e) ** 3
    if kind == "total":
        return fake_mu(z, e, "coh") + fake_mu(z, e, "incoh") + fake_mu(z, e, "photo")
    return base * np.ones_like(e)


def _energies(seed, n=2_000, hi=250_000.0):
    rng = np.random.default_rng(seed)
    return np.concatenate([[0.0, 1.0], np.sort(rng.uniform(0.0, hi, n))])


def _equal(a, b):
    assert np.asarray(a).dtype == np.asarray(b).dtype
    np.testing.assert_array_equal(a, b)


def _tables_equal(ours, theirs):
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if isinstance(a, np.ndarray):
            _equal(a, b)
        else:
            assert a == b, f.name


def _generated_equal(ours, theirs):
    for name in ("name", "formula", "density"):
        assert getattr(ours, name) == getattr(theirs, name)
    for name in ("energies", "mfp", "rayleigh_pmax", "shells"):
        _equal(getattr(ours, name), getattr(theirs, name))
    for a, b in zip(ours.rita + ours.rita_limits, theirs.rita + theirs.rita_limits):
        _equal(a, b)


@pytest.mark.parametrize("formula", FORMULAS)
def test_parse_formula_matches_jax(formula):
    assert tgen.parse_formula(formula) == jgen.parse_formula(formula)


def test_unknown_element_raises_in_both():
    for gen in (jgen, tgen):
        with pytest.raises(ValueError, match="Unknown element Xx"):
            gen.parse_formula("Xx2")
    assert tgen.ATOMIC == jgen.ATOMIC


@pytest.mark.parametrize("z", ELEMENTS)
def test_form_factors_match_jax(z):
    e = _energies(z)
    _equal(tgen.theoretical_form_factor(e, z), jgen.theoretical_form_factor(e, z))
    _equal(tgen.atomic_form_factor(e, z), jgen.atomic_form_factor(e, z))


@pytest.mark.parametrize("formula", FORMULAS)
def test_compound_form_factor_and_shells_match_jax(formula):
    e = _energies(len(formula))
    for ours, theirs in zip(tgen.compound_form_factor_squared(formula, e),
                            jgen.compound_form_factor_squared(formula, e)):
        _equal(ours, theirs)
    _equal(tgen.compound_shells(formula), jgen.compound_shells(formula))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rita_table_and_limits_match_jax(seed):
    rng = np.random.default_rng(seed)
    x2 = np.linspace(0.0, rng.uniform(20.0, 400.0), 20_001)
    pdf = np.exp(-x2 / rng.uniform(2.0, 10.0)) + rng.uniform(0.0, 0.5) * np.exp(
        -((np.sqrt(x2) - rng.uniform(1.0, 5.0)) ** 2))
    for ours, theirs in zip(tgen.build_rita_table(x2, pdf), jgen.build_rita_table(x2, pdf)):
        _equal(ours, theirs)
    cdf = np.sort(rng.uniform(0.0, 1.0, 128))
    cdf[0], cdf[-1] = 0.0, 1.0
    for ours, theirs in zip(tgen.binary_search_limits(cdf), jgen.binary_search_limits(cdf)):
        _equal(ours, theirs)


@pytest.fixture(scope="module", params=[("testwater", "H2O", 1.0), ("acrylic", "C5H8O2", 1.19)],
                ids=["H2O", "C5H8O2"])
def generated(request):
    name, formula, density = request.param
    kw = dict(density=density, e_max=30_000.0, mu_rho_fn=fake_mu)
    return (tgen.generate_material(name, formula, **kw),
            jgen.generate_material(name, formula, **kw))


def test_generate_material_matches_jax(generated):
    ours, theirs = generated
    _generated_equal(ours, theirs)
    assert len(ours.rita[0]) == 128 and ours.mfp.shape == (4, len(ours.energies))


def test_mcgpu_files_same_text_and_cross_parse(generated, tmp_path):
    ours, theirs = generated
    name = f"{ours.name}__5_30kev.mcgpu"
    p_ours = tgen.write_mcgpu_file(ours, tmp_path / "port" / name)
    p_theirs = jgen.write_mcgpu_file(theirs, tmp_path / "jax" / name)
    assert p_ours.read_text() == p_theirs.read_text()
    for path in (p_ours, p_theirs):
        _tables_equal(tmaterials.parse_mcgpu_material_file(path),
                      jmaterials.parse_mcgpu_material_file(path))
    parsed = tmaterials.parse_mcgpu_material_file(p_theirs)
    assert parsed.identifier == ours.name and parsed.chemical_formula == ours.formula
    _equal(parsed.mfp_total, ours.mfp[3].astype(np.float32))


def test_generated_material_interop_writes_the_jax_file(generated, tmp_path):
    _, theirs = generated
    carried = interop.generated_material_from_numpy(dataclasses.asdict(theirs))
    _generated_equal(carried, theirs)
    a = tgen.write_mcgpu_file(carried, tmp_path / "a.mcgpu").read_text()
    assert a == jgen.write_mcgpu_file(theirs, tmp_path / "b.mcgpu").read_text()


def test_without_xraydb_or_mu_rho_fn_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "xraydb", None)  # import xraydb now raises ImportError
    for gen in (tgen, jgen):
        with pytest.raises(RuntimeError, match="No mass-attenuation source"):
            gen.generate_material("w", "H2O", 1.0, e_max=30_000.0)


def test_generated_water_slab_engine_matches_jax(tmp_path):
    """Water generated at the shipped grid (5-125 keV in 5 eV steps) with the
    shipped water's attenuation: its total mean free paths are the shipped
    ones; the port's engine on the CPU over the golden slab with that water
    agrees with the JAX engine's channel sums on the same tables."""
    from chip_smoke import shipped_mu_rho
    from test_transport import CONFIG as JCONFIG
    from test_transport import _make_run as jax_make_run

    from cbctmc_tpu.physics.spectrum import Spectrum as JSpectrum
    from cbctmc_tpu_torch.engine.tables import build_device_tables
    from cbctmc_tpu_torch.physics.spectrum import Spectrum
    from test_torch_transport import _make_run, _scene

    jts = jmaterials.default_material_set()
    mu_rho, shipped = shipped_mu_rho(jts, "h2o")
    water = jgen.generate_material("h2o", "H2O", shipped.density, mu_rho_fn=mu_rho)
    path = jgen.write_mcgpu_file(water, tmp_path / "h2o__5_125kev.mcgpu")
    _equal(jmaterials.parse_mcgpu_material_file(path).mfp_total, shipped.mfp_total)

    jmats = list(jts.materials)
    jmats[jts.index_of("h2o")] = jmaterials.parse_mcgpu_material_file(path)
    jset = jmaterials.MaterialTableSet(materials=jmats)
    tset = interop.material_set_from_numpy([dataclasses.asdict(m) for m in jset.materials])
    _tables_equal(tset.materials[tset.index_of("h2o")],
                  tmaterials.parse_mcgpu_material_file(path))

    energies, probs = np.array([59_995.0, 60_005.0], np.float32), np.array([1.0], np.float32)
    mats, dens = _scene(tset, True)
    jrun = jax_make_run(jset, JSpectrum("mono60", energies, probs), mats, dens, config=JCONFIG)
    jax_sums = np.array([np.asarray(jrun(120_000, 1234 + k), np.float64).sum(axis=(1, 2))
                         for k in range(2)])
    tables = build_device_tables(tset, Spectrum("mono60", energies, probs), device="cpu")
    run = _make_run(tset, tables, mats, dens)
    sums = np.array([run(120_000, 1234 + k).double().numpy().sum(axis=(1, 2))
                     for k in range(4)])
    mean, s = sums.mean(axis=0), sums.std(axis=0, ddof=1)
    bound = 4.0 * np.sqrt(s**2 / 4 + s**2)
    assert (s > 0).all()
    for reference in jax_sums:
        assert (np.abs(mean - reference) <= bound).all(), (mean, reference, bound)
