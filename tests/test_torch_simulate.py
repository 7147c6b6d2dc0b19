"""The port's scan driver on the CPU: MCScanner (chunking with the survivor
carry, two projections, normalised images) and the numpy helpers around
it against the JAX package's."""

import numpy as np
import torch

from cbctmc_tpu_torch.engine import kernels, simulate
from cbctmc_tpu_torch.engine.simulate import MCScanner, SimulationParameters
from cbctmc_tpu_torch.engine.transport import production_engine_config
from cbctmc_tpu_torch.physics.materials import default_material_set

torch.set_num_threads(2)


def _water_slab_scene(table_set):
    """20 cm air cube with a 5 cm water slab across the beam, 5 mm voxels."""
    air = table_set.material("air")
    water = table_set.material("h2o")
    mats = np.full((40, 40, 40), air.number, np.uint8)
    dens = np.full((40, 40, 40), air.density, np.float32)
    mats[:, 15:25, :] = water.number
    dens[:, 15:25, :] = water.density
    return mats, dens


def test_mcscanner_cpu_end_to_end(monkeypatch):
    """MCScanner on the CPU: a water slab, two angles, each projection in
    three chunks linked by the survivor carry; finite images with the
    primary channel dominant, every history started exactly once, and no
    kernel launched (a CPU tensor takes the plain versions)."""
    monkeypatch.setattr(simulate, "PILOT_CHUNK", 9_000)
    mats, dens = _water_slab_scene(default_material_set())
    params = SimulationParameters(
        n_detector_pixels=(24, 16), detector_size=(400.0, 300.0),
        source_to_detector_distance=600.0, source_to_isocenter_distance=400.0,
        source_polar_aperture=(-1.0, -1.0),
    )
    scanner = MCScanner(mats, dens, (5.0, 5.0, 5.0), parameters=params,
                        engine_config=production_engine_config(n_lanes=4096),
                        device="cpu")
    kernels.reset_launch_counts()
    images, info = scanner.simulate(angles_deg=[270.0, 90.0], n_histories=24_000, seed=0)
    assert images.shape == (2, 4, 16, 24)
    assert np.isfinite(images).all()
    sums = images.sum(axis=(2, 3))
    assert (sums > 0).all()
    assert (sums.argmax(axis=1) == 0).all()
    assert info.iterations > 0
    assert info.counts[5] + info.counts[6] == 2 * 24_000
    assert sum(kernels.launch_counts.values()) == 0


def test_host_helpers_match_jax_package():
    """The numpy helpers around the scan equal the JAX package's on the
    same seeded inputs."""
    from cbctmc_tpu.engine import simulate as jsim

    rng = np.random.default_rng(0)
    images = rng.uniform(0.1, 2.0, (2, 4, 30, 52))
    np.testing.assert_array_equal(simulate.crop_half_fan(images, 40),
                                  jsim.crop_half_fan(images, 40))
    for factor in (1, 2, 3):
        np.testing.assert_array_equal(simulate.bin_detector(images, factor),
                                      jsim.bin_detector(images, factor))
    air = rng.uniform(1.0, 2.0, (30, 52))
    proj = images[0, 0] * (rng.uniform(size=(30, 52)) > 0.1)
    for sigma, clip in (((3.0, 2.0), False), (None, True)):
        np.testing.assert_allclose(
            simulate.air_normalize(proj, air, denoise_sigma=sigma, clip_to_air=clip),
            jsim.air_normalize(proj, air, denoise_sigma=sigma, clip_to_air=clip),
            rtol=1e-12,
        )
    mats = rng.integers(1, 5, (6, 7, 8)).astype(np.uint8)
    dens = rng.uniform(0.001, 2.0, (6, 7, 8)).astype(np.float32)
    ours = simulate.geometry_to_engine_frame(mats, dens, (1.0, 2.0, 3.0))
    theirs = jsim.geometry_to_engine_frame(mats, dens, (1.0, 2.0, 3.0))
    np.testing.assert_array_equal(ours[0], theirs[0])
    np.testing.assert_array_equal(ours[1], theirs[1])
    assert ours[2] == theirs[2]


def test_shared_tables_follow_in_place_edits(monkeypatch):
    """``shared_device_tables`` keys on contents: equal table sets and
    spectra share one build, and an edit in place of either, after a build,
    gets a build of its own (the build stubbed: it is counted, not run)."""
    import copy

    from cbctmc_tpu_torch.physics.spectrum import default_spectrum

    builds = []
    monkeypatch.setattr(simulate, "_SHARED_TABLES", {})
    monkeypatch.setattr(simulate, "build_device_tables",
                        lambda ts, sp, device=None: builds.append(object()) or builds[-1])
    table_set = copy.deepcopy(default_material_set())
    spectrum = copy.deepcopy(default_spectrum())
    cpu = torch.device("cpu")
    first = simulate.shared_device_tables(table_set, spectrum, cpu)
    assert simulate.shared_device_tables(table_set, spectrum, cpu) is first
    # equal contents, other objects: the same build
    assert simulate.shared_device_tables(copy.deepcopy(table_set), copy.deepcopy(spectrum),
                                         cpu) is first
    assert len(builds) == 1
    peak = int(np.argmax(spectrum.probabilities))
    spectrum.probabilities[peak] *= 2.0
    edited_spectrum = simulate.shared_device_tables(table_set, spectrum, cpu)
    assert edited_spectrum is not first and len(builds) == 2
    mfp, density = float(table_set.materials[1].mfp_total[10]), table_set.materials[1].density
    table_set.materials[1].mfp_total[10] *= 1.5
    edited_set = simulate.shared_device_tables(table_set, spectrum, cpu)
    assert edited_set is not edited_spectrum and len(builds) == 3
    table_set.materials[1].density = density + 0.25
    assert simulate.shared_device_tables(table_set, spectrum, cpu) is not edited_set
    assert len(builds) == 4
    # the edits undone: the contents of the first build again
    table_set.materials[1].density = density
    table_set.materials[1].mfp_total[10] = mfp
    spectrum.probabilities[peak] /= 2.0
    assert simulate.tables_key(table_set, spectrum) == simulate.tables_key(
        default_material_set(), default_spectrum())
    assert simulate.shared_device_tables(table_set, spectrum, cpu) is first
    assert len(builds) == 4


def test_scanner_after_a_spectrum_edit_gets_fresh_tables(monkeypatch):
    """A spectrum edited in place after a first scanner was built with it:
    the next scanner's device tables are those of the edited spectrum (the
    JAX package rebuilds them for every scanner), and a copy of the edited
    spectrum shares them."""
    import copy

    from cbctmc_tpu_torch.engine.tables import build_device_tables
    from cbctmc_tpu_torch.physics.spectrum import build_walker_alias, default_spectrum

    monkeypatch.setattr(simulate, "_SHARED_TABLES", {})
    mats, dens = _water_slab_scene(default_material_set())
    spectrum = copy.deepcopy(default_spectrum())

    def scanner(sp):
        return MCScanner(mats, dens, (5.0, 5.0, 5.0), spectrum=sp,
                         engine_config=production_engine_config(n_lanes=4096), device="cpu")

    before = scanner(spectrum).tables
    spectrum.probabilities[: spectrum.n_bins // 2] = 0.0
    spectrum.cutoff[:], spectrum.alias[:] = build_walker_alias(spectrum.probabilities)
    after = scanner(spectrum).tables
    assert after is not before
    assert not torch.equal(after.spectrum_cutoff, before.spectrum_cutoff)
    fresh = build_device_tables(default_material_set(), spectrum, device="cpu")
    assert torch.equal(after.spectrum_cutoff, fresh.spectrum_cutoff)
    assert torch.equal(after.spectrum_alias, fresh.spectrum_alias)
    assert scanner(copy.deepcopy(spectrum)).tables is after
