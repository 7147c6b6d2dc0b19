"""The port's training data and workflows against the JAX package's on the
CPU: the speedup triplets and both datasets (bit-equal batches for one
seed), the real-CT ingestion (TotalSegmentator merge, ``preprocess_case``,
the pickles read across the two packages), the synthetic-CT generator
(bit-equal to ``scripts/generate_synthetic_ct.py``), and the training
workflows end to end at toy size: the speedup pipeline on a small scene
through the port's engine (its checkpoint read by the JAX ``load_params``),
the synthetic segmenter's training with its two-threshold gate, and the
``train-speedup`` / ``train-segmentation`` commands.

Tolerances: none. Everything here is numpy on both sides and compared
bit for bit; the toy workflows are checked for their files, finite losses
and the gate's verdict.
"""

import gzip
import pickle
import sys

import jax
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from cbctmc_tpu.models import datasets as jdatasets
from cbctmc_tpu.models import real_ct as jreal_ct
from cbctmc_tpu.models.checkpoints import load_params as jload_params
from cbctmc_tpu.models.speedup_net import MCSpeedUpNet as JMCSpeedUpNet

from cbctmc_tpu_torch import interop
from cbctmc_tpu_torch.models import checkpoints, datasets, real_ct, synthetic_ct
from cbctmc_tpu_torch.models.flex_unet import FlexUNet
from cbctmc_tpu_torch.models.speedup_net import MCSpeedUpNet
from cbctmc_tpu_torch.pipeline import training_workflows
from cbctmc_tpu_torch.utils.io import write_image

from test_real_ct_pipeline import _make_case
from test_torch_boundary import REPO
from test_torch_models import _leaves

torch.set_num_threads(4)

sys.path.insert(0, str(REPO / "scripts"))
import generate_synthetic_ct  # noqa: E402


def _triplets(folder, n=5, shape=(40, 48), with_fp=True, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n):
        low = rng.gamma(4.0, 0.25, shape)
        high = 0.9 * low + rng.normal(0.0, 0.02, shape)
        fp = 3.0 * low + 1.0 if with_fp else None
        datasets.create_speedup_training_example(low, high, fp, folder, stem=f"case_{i:03d}")


def _same_batches(ours, theirs, n):
    for a, b in zip([next(ours) for _ in range(n)], [next(theirs) for _ in range(n)]):
        assert sorted(a) == sorted(b)
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


# ---------------------------------------------------------------------------
# the datasets
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_fp,normalize,patch", [(True, True, (32, 16)), (False, True, (64, 64)),
                                                     (True, False, (16, 16))])
def test_speedup_dataset_batches_equal_jax(with_fp, normalize, patch, tmp_path):
    _triplets(tmp_path, with_fp=with_fp)
    kw = dict(batch_size=3, patch_shape=patch, seed=4, normalize_by_low_mean=normalize)
    _same_batches(iter(datasets.SpeedupProjectionDataset(tmp_path, **kw)),
                  iter(jdatasets.SpeedupProjectionDataset(tmp_path, **kw)), 3)


def test_speedup_dataset_from_simulation_equals_jax(tmp_path):
    """Triplets from two simulation folders' total stacks and a forward
    projection image, by both packages: the same files, bit for bit."""
    rng = np.random.default_rng(1)
    for name in ("low", "high"):
        stack = rng.gamma(2.0, 1.0, (3, 8, 12)).astype(np.float32)  # [view, v, u]
        (tmp_path / name).mkdir()
        write_image(np.transpose(stack, (2, 1, 0)), tmp_path / name / "projections_total.mha")
    fp = tmp_path / "fp.mha"
    write_image(rng.random((12, 8, 3)).astype(np.float32), fp)
    for out, module in (("ours", datasets), ("theirs", jdatasets)):
        module.create_speedup_dataset_from_simulation(tmp_path / "low", tmp_path / "high",
                                                      tmp_path / out, forward_projection_path=fp)
    names = sorted(p.name for p in (tmp_path / "ours").iterdir())
    assert len(names) == 9 and names == sorted(p.name for p in (tmp_path / "theirs").iterdir())
    for name in names:
        assert (tmp_path / "ours" / name).read_bytes() == (tmp_path / "theirs" / name).read_bytes()


@pytest.mark.parametrize("patch,batch", [((16, 16, 16), 2), ((40, 12, 24), 1)])
def test_segmentation_dataset_batches_equal_jax(patch, batch):
    """Patches of two small synthetic cases: balanced sampling, rotations,
    noise and value shifts draw the same numbers in both packages."""
    cases = [synthetic_ct.generate_case(seed, shape=(64, 48, 32)) for seed in (1, 2)]
    kw = dict(images=[c[0] for c in cases], labels=[c[1] for c in cases], patch_shape=patch,
              batch_size=batch, seed=9)
    _same_batches(iter(datasets.SegmentationPatchDataset(**kw)),
                  iter(jdatasets.SegmentationPatchDataset(**kw)), 4)


# ---------------------------------------------------------------------------
# real-CT ingestion
# ---------------------------------------------------------------------------
def test_merge_total_segmentator_folder_equals_jax(tmp_path):
    _make_case(tmp_path / "seg")
    ours = real_ct.merge_total_segmentator_folder(tmp_path / "seg")
    theirs = jreal_ct.merge_total_segmentator_folder(tmp_path / "seg")
    assert ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)
    assert real_ct.TOTAL_SEGMENTATOR_MERGE_PATTERNS == jreal_ct.TOTAL_SEGMENTATOR_MERGE_PATTERNS
    with pytest.raises(FileNotFoundError):
        real_ct.merge_total_segmentator_folder(tmp_path)


@pytest.mark.parametrize("spacing", [(2.0, 2.0, 2.0), (1.0, 1.0, 1.0)])
def test_preprocess_case_and_pickles_across_packages(spacing, tmp_path):
    """Both packages compile the case (resampled to 1 mm where it is not);
    each reads the other's pickle; the training volumes are equal."""
    image, _ = _make_case(tmp_path / "seg", spacing=spacing)
    write_image(image, tmp_path / "ct.nii.gz", spacing=spacing)
    paths = {}
    for name, module in (("ours", real_ct), ("theirs", jreal_ct)):
        paths[name] = module.preprocess_case(tmp_path / "ct.nii.gz", tmp_path / "seg",
                                             tmp_path / name / "case_000.pkl.gz")
    for reader in (real_ct.load_pickle, jreal_ct.load_pickle):
        a, b = reader(paths["ours"]), reader(paths["theirs"])
        assert sorted(a) == sorted(b)
        for key in a:
            if isinstance(a[key], np.ndarray):
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])
            else:
                assert a[key] == b[key]
    ours = real_ct.load_training_volumes(real_ct.PickleDataset.from_folder(tmp_path / "ours"))
    theirs = jreal_ct.load_training_volumes(jreal_ct.PickleDataset.from_folder(tmp_path / "ours"))
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a[0], b[0])
    assert ours[0][0].shape == tuple(int(n * spacing[0]) for n in (24, 20, 16))
    with gzip.open(paths["ours"], "rb") as f:
        assert pickle.load(f)["image_spacing"] == (1.0, 1.0, 1.0)


def test_preprocess_rejects_shape_mismatch_and_lz4_as_jax(tmp_path):
    image, _ = _make_case(tmp_path / "seg")
    write_image(image[:-2], tmp_path / "ct.nii.gz", spacing=(2.0, 2.0, 2.0))
    for module in (real_ct, jreal_ct):
        with pytest.raises(ValueError):
            module.preprocess_case(tmp_path / "ct.nii.gz", tmp_path / "seg",
                                   tmp_path / "case.pkl.gz")
        try:
            import lz4.frame  # noqa: F401
        except ImportError:
            with pytest.raises(ImportError):
                module.save_pickle({"a": 1}, tmp_path / "case.lz4")
            with pytest.raises(ImportError):
                module.load_pickle(tmp_path / "case.lz4")


@pytest.mark.parametrize("seed", [1000, 1007])
def test_synthetic_case_equals_jax_script(seed):
    ours = synthetic_ct.generate_case(seed)
    theirs = generate_synthetic_ct.generate_case(seed)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the workflows at toy size
# ---------------------------------------------------------------------------
def _toy_scene():
    from cbctmc_tpu_torch.geometry.mc_geometry import MCGeometry
    from cbctmc_tpu_torch.physics.materials import default_material_set

    ts = default_material_set()
    air, water = ts.material("air"), ts.material("h2o")
    shape = (24, 24, 24)
    mats = np.full(shape, air.number, np.uint8)
    dens = np.full(shape, air.density, np.float32)
    mats[8:16, 8:16, 6:18] = water.number
    dens[8:16, 8:16, 6:18] = water.density
    return MCGeometry(mats, dens, image_spacing=(8.0, 8.0, 8.0))


TOY_NET = dict(mean_filter_base=2, mean_levels=2, var_filter_base=2, var_levels=1)


def toy_speedup_pipeline(monkeypatch):
    """The speedup pipeline's scenes, detector, FP panel and net at toy
    size: one 24^3 scene at 8 mm, a 32 x 32 detector and panel of 12.5 mm
    pixels, a small ``MCSpeedUpNet``."""
    from cbctmc_tpu_torch.engine import simulate
    from cbctmc_tpu_torch.models import speedup_net
    from cbctmc_tpu_torch.recon.geometry import ConeBeamGeometry

    class ToyParameters(simulate.SimulationParameters):
        def __init__(self, **kw):
            super().__init__(n_detector_pixels=(32, 32), detector_size=(400.0, 400.0),
                             source_polar_aperture=(-1.0, -1.0),
                             source_azimuthal_aperture=-1.0, **kw)

    monkeypatch.setattr(simulate, "SimulationParameters", ToyParameters)
    monkeypatch.setattr(training_workflows, "speedup_scenes", lambda: {"toy": _toy_scene()})
    monkeypatch.setattr(training_workflows, "speedup_fp_geometry", lambda: ConeBeamGeometry(
        n_pixels_u=32, n_pixels_v=32, pixel_size_u=12.5, pixel_size_v=12.5,
        detector_offset_u=0.0))
    class ToyNet(MCSpeedUpNet):
        def __init__(self):
            super().__init__(**TOY_NET)

    monkeypatch.setattr(speedup_net, "MCSpeedUpNet", ToyNet)


def test_speedup_pipeline_end_to_end_on_a_toy_scene(tmp_path, monkeypatch):
    """Simulate 8 views low and high through the port's engine, forward
    project, build the triplets (view 7 held out), train 4 steps across the
    pretrain switch, evaluate the holdout, publish through the gate. The
    final checkpoint loads in the JAX package's ``load_params``."""
    toy_speedup_pipeline(monkeypatch)
    asset = tmp_path / "asset"
    out = training_workflows.run_speedup_pipeline(
        tmp_path / "run", n_views=8, n_low=1e3, n_high=5e3, n_lanes=1024, train_steps=4,
        pretrain_steps=2, batch_size=2, patch=32, asset_dir=asset, device="cpu")
    run = tmp_path / "run"
    assert len(list((run / "triplets").glob("toy_*_low.npy"))) == 7
    assert [p.name for p in (run / "holdout").glob("*_low.npy")] == ["toy_007_low.npy"]
    low = np.load(run / "holdout" / "toy_007_low.npy")
    assert low.shape == (32, 32) and np.isfinite(low).all() and low.max() > 0
    assert len(out["losses"]) == 4 and np.isfinite(out["losses"]).all()
    assert len(out["walls"]["train_steps_s"]) == 4
    report = out["report"]
    assert set(report) == {"toy_007", "mean_psnr_gain_db"}
    assert np.isfinite(report["mean_psnr_gain_db"])
    assert out["published"] == (report["mean_psnr_gain_db"] > 0.0)
    if out["published"]:
        assert (asset / "default.ckpt").read_bytes() == out["checkpoint"].read_bytes()
        assert checkpoints.asset_has_passing_stamp(asset)
    else:
        assert not asset.exists()
    template = JMCSpeedUpNet(**TOY_NET).init(
        jax.random.PRNGKey(0), np.ones((1, 32, 32, 2), np.float32))["params"]
    loaded = dict(_leaves(jload_params(template, out["checkpoint"])))
    trained = interop.flax_tree_from_state_dict(MCSpeedUpNet(**TOY_NET), out["params"])
    for path, value in _leaves(trained):
        np.testing.assert_array_equal(np.asarray(loaded[path]), value)


@pytest.mark.parametrize("passes", [True, False])
def test_train_segmenter_synthetic_end_to_end(passes, tmp_path, monkeypatch):
    """Three synthetic cases, the last held out; 2 steps of a small
    segmenter; the held-out Dice through MCSegmenter; the gate at floors 0
    (passes) or above 1 (fails), the asset written or left untouched."""
    synthetic_ct.write_cases(tmp_path / "data", n_cases=3, shape=(64, 48, 32))
    asset = tmp_path / "asset"
    asset.mkdir()
    (asset / "default.ckpt").write_bytes(b"old weights")
    floor = 0.0 if passes else 1.1
    from cbctmc_tpu_torch.models import segmentation

    monkeypatch.setattr(segmentation, "default_segmenter_model", lambda: FlexUNet(
        n_channels=1, n_classes=9, n_levels=1, ndim=3, filter_base=4))
    out = training_workflows.train_segmenter_synthetic(
        tmp_path / "data", tmp_path / "train", n_steps=2, patch_shape=(16, 16, 16),
        n_holdout=1, min_dice=floor, min_class_dice=floor, asset_dir=asset, device="cpu")
    report = out["report"]
    assert (report["n_steps"], report["n_train"], report["n_holdout"]) == (2, 2, 1)
    assert len(report["per_volume"]) == 1 and len(report["per_class_mean_dice"]) == 7
    assert 0.0 <= report["mean_foreground_dice"] <= 1.0
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert out["published"] is passes
    published = (asset / "default.ckpt").read_bytes()
    assert published == ((tmp_path / "train" / "final.ckpt").read_bytes() if passes
                         else b"old weights")
    assert checkpoints.asset_has_passing_stamp(asset) is passes


def test_train_speedup_and_train_segmentation_commands(tmp_path):
    """The command line's train-speedup (both architectures) and
    train-segmentation, one step each at full width on small inputs."""
    _triplets(tmp_path / "triplets", n=3, shape=(32, 32))
    image = tmp_path / "ct.mha"
    case = synthetic_ct.generate_case(3, shape=(64, 48, 32))
    write_image(case[0], image)
    labels = tmp_path / "labels.npy"
    np.save(labels, case[1])
    runner = CliRunner()
    for args in (["train-speedup", "--data-folder", tmp_path / "triplets", "--output-dir",
                  tmp_path / "unet", "--n-steps", "1", "--batch-size", "2"],
                 ["train-speedup", "--data-folder", tmp_path / "triplets", "--output-dir",
                  tmp_path / "separated", "--n-steps", "1", "--batch-size", "1",
                  "--architecture", "separated"],
                 ["train-segmentation", "--image", image, "--labels", labels, "--output-dir",
                  tmp_path / "segmenter", "--n-steps", "1"]):
        result = runner.invoke(training_workflows.main,
                               [str(a) for a in args] + ["--device", "cpu"],
                               catch_exceptions=False)
        assert result.exit_code == 0, result.output
    for name, leaves in (("unet", 56), ("separated", 92), ("segmenter", 36)):
        tree = checkpoints.load_flax_checkpoint(tmp_path / name / "final.ckpt")
        values = [v for _, v in _leaves(tree)]
        assert len(values) == leaves and all(np.isfinite(v).all() for v in values)
