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
