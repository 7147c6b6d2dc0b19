"""Scene packing of the port against the JAX package: the packed u32 voxel
word is bit-equal (material | air level | soft level | density), and so are
the non-air box and scale fields, on the transport-test scenes and on the
64^3 / 4 mm CatPhan (the bench smoke scene). A primary-only volume, whose
engine view is a dummy, is rejected at the engine's entry."""

import numpy as np
import pytest
import torch

from cbctmc_tpu.engine import transport as jtransport
from cbctmc_tpu.engine.primary import uniform_clearance_volume
from cbctmc_tpu.geometry.phantoms import CatPhan604Geometry as JaxCatPhan
from cbctmc_tpu.physics.materials import default_material_set as jax_material_set
from cbctmc_tpu_torch import interop
from cbctmc_tpu_torch.engine import transport as ttransport
from cbctmc_tpu_torch.engine.ct import ScanGeometry, build_scan, select_projection
from cbctmc_tpu_torch.engine.rng import make_key
from cbctmc_tpu_torch.engine.tables import build_device_tables
from cbctmc_tpu_torch.geometry.phantoms import CatPhan604Geometry
from cbctmc_tpu_torch.physics.materials import default_material_set
from cbctmc_tpu_torch.physics.spectrum import Spectrum

from test_transport import _scene

torch.set_num_threads(2)

VOLUME_FIELDS = ("bbox", "voxel_size", "den_scale", "air_den_max", "voxmin",
                 "nonair_lo", "nonair_hi")


@pytest.fixture(scope="module")
def table_set():
    return default_material_set()


def _catphan_64(table_set):
    phantom = CatPhan604Geometry(shape=(64, 64, 64), image_spacing=(4.0,) * 3)
    mats = np.ascontiguousarray(np.rot90(phantom.materials, k=3, axes=(0, 1)))
    dens = np.ascontiguousarray(np.rot90(phantom.densities, k=3, axes=(0, 1)))
    return mats.astype(np.int32) - 1, dens, (0.4, 0.4, 0.4)


def _assert_volume_equal(tv, jv):
    assert tuple(tv.shape) == tuple(jv.shape)
    np.testing.assert_array_equal(tv.packed.numpy().view(np.uint32), np.asarray(jv.packed))
    for k in VOLUME_FIELDS:
        np.testing.assert_array_equal(getattr(tv, k).numpy(), np.asarray(getattr(jv, k)))


@pytest.mark.parametrize("with_slab", [False, True])
def test_voxel_volume_bit_equal_transport_scenes(table_set, with_slab):
    mats, dens = _scene(jax_material_set(), with_water_slab=with_slab)
    m0 = mats.astype(np.int32) - 1
    jv = jtransport.make_voxel_volume(m0, dens, (0.5, 0.5, 0.5))
    tv = ttransport.make_voxel_volume(m0, dens, (0.5, 0.5, 0.5), device="cpu")
    _assert_volume_equal(tv, jv)


def test_catphan_geometry_equal(table_set):
    port = CatPhan604Geometry(shape=(64, 64, 64), image_spacing=(4.0,) * 3)
    ref = JaxCatPhan(shape=(64, 64, 64), image_spacing=(4.0,) * 3)
    np.testing.assert_array_equal(port.materials, ref.materials)
    np.testing.assert_array_equal(port.densities, ref.densities)


def test_make_scene_bit_equal_catphan64(table_set):
    """The two-tier scene (heavy mask -> soft clearance bits + soft
    majorant) of the bench smoke CatPhan."""
    m0, dens, spacing = _catphan_64(table_set)
    jv, jw = jtransport.make_scene(jax_material_set(), m0, dens, spacing)
    tv, tw = ttransport.make_scene(table_set, m0, dens, spacing, device="cpu")
    _assert_volume_equal(tv, jv)
    # the soft clearance tier is populated (bits 21-23)
    assert ((tv.packed >> 21) & 7).max() > 0
    for k in tw._fields:
        np.testing.assert_array_equal(getattr(tw, k).numpy(), np.asarray(getattr(jw, k)))


def test_unpacked_fields_mask_high_materials(table_set):
    """Materials >= 16 set the word's sign bit in int32: every field is
    masked, so material and density come out right."""
    mats = np.full((4, 4, 4), 20, np.int32)  # teflon, 0-based
    mats[0] = 0
    dens = np.full((4, 4, 4), 2.2, np.float32)
    tv = ttransport.make_voxel_volume(mats, dens, (1.0,) * 3, device="cpu")
    assert (tv.packed < 0).any()
    m = tv.material.numpy()[: mats.size].reshape(4, 4, 4).transpose(2, 1, 0)
    np.testing.assert_array_equal(m, mats)
    np.testing.assert_allclose(tv.density.numpy()[: mats.size], 2.2, rtol=1e-6)


def test_interop_volume_equal(table_set):
    m0, dens, spacing = _catphan_64(table_set)
    jv, _ = jtransport.make_scene(jax_material_set(), m0, dens, spacing)
    fields = {k: np.asarray(v) for k, v in jv._asdict().items()}
    _assert_volume_equal(interop.volume_from_numpy(fields, device="cpu"), jv)


def _engine_inputs(table_set, volume):
    mono = Spectrum("mono60", np.array([59_995.0, 60_005.0], np.float32),
                    np.array([1.0], np.float32))
    tables = build_device_tables(table_set, mono, device="cpu")
    max_density = np.ones(table_set.n_materials, np.float32)
    from cbctmc_tpu_torch.engine.tables import build_woodcock_table

    woodcock = build_woodcock_table(table_set, max_density, device="cpu")
    geom = ScanGeometry(
        n_pixels_x=8, n_pixels_z=8, detector_size_x=20.0, detector_size_z=20.0,
        sdd=60.0, sad=40.0, aperture_phi1=-1.0, aperture_phi2=-1.0,
        aperture_theta=-1.0, source_position_0=(10.0, -30.0, 10.0),
    )
    src, det = build_scan(geom, [270.0], device="cpu")
    return tables, woodcock, select_projection(src, 0), select_projection(det, 0)


def test_primary_only_volume_rejected(table_set):
    """The JAX primary-only repack keeps a 2-word dummy as the engine's
    gather view; through interop the port sees that view and refuses it
    instead of transporting through a clamped vacuum."""
    mats, dens = _scene(jax_material_set(), with_water_slab=True)
    jv = jtransport.make_voxel_volume(mats.astype(np.int32) - 1, dens, (0.5,) * 3)
    uni = uniform_clearance_volume(jv)
    volume = interop.volume_from_numpy(
        {k: np.asarray(v) for k, v in uni._asdict().items()}, device="cpu"
    )
    assert volume.packed.shape[0] < 40 ** 3
    tables, woodcock, src, det = _engine_inputs(table_set, volume)
    cfg = ttransport.EngineConfig(n_lanes=256, max_virtual_trips=2)
    with pytest.raises(ValueError, match="primary-only"):
        ttransport.run_projection(
            tables, woodcock, volume, src, det, 1000, make_key(0),
            8, 8, config=cfg, device="cpu",
        )


def test_short_packed_volume_rejected(table_set):
    mats, dens = _scene(jax_material_set(), with_water_slab=False)
    tv = ttransport.make_voxel_volume(mats.astype(np.int32) - 1, dens, (0.5,) * 3,
                                      device="cpu")
    short = tv._replace(packed=tv.packed[:100].clone())
    with pytest.raises(ValueError):
        ttransport.validate_volume(short)
    ttransport.validate_volume(tv)
