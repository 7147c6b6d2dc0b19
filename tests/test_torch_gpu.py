"""The port's CUDA kernels on the card, each against its plain version.

These tests import no JAX, so they run on a machine with a card and
without the JAX package's dependencies:
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``.
Without a card they skip."""

import dataclasses
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from cbctmc_tpu_torch.engine import kernels
from cbctmc_tpu_torch.engine.kernels import FlightLanes
from cbctmc_tpu_torch.engine import transport
from cbctmc_tpu_torch.engine.rng import make_key, philox4x32_10, philox_bits
from torch_kernel_inputs import (
    clone_lanes,
    prototype_inputs,
    slab_engine,
    state_diff,
    state_in_mid_run,
    step_world,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gather_kernel_on_card(cuda):
    assert kernels.probe_gather(cuda) is True
    table, idx = kernels.probe_inputs(cuda)
    torch.testing.assert_close(kernels.gather(table, idx),
                               kernels.gather_reference(table, idx), rtol=0, atol=0)


@pytest.mark.gpu
def test_flight_prototype_kernel_on_card(cuda):
    inp = {k: torch.from_numpy(v).to(cuda) for k, v in prototype_inputs(0).items()}
    before = kernels.launch_counts["flight_prototype"]
    pos, flags = kernels.flight_prototype(**inp)
    assert kernels.launch_counts["flight_prototype"] == before + 1
    ref_pos, ref_flags = kernels.flight_prototype_reference(**inp)
    torch.testing.assert_close(pos, ref_pos, rtol=1e-6, atol=1e-6)
    assert int((flags[:2] != ref_flags[:2]).any(0).sum()) <= 1


@pytest.mark.gpu
def test_flight_step_kernel_on_card(cuda):
    lanes, cand, consts, rng = step_world(n=4096, seed=7)
    n = 4096
    move = lambda tup: type(tup)(*(t.to(cuda) for t in tup))
    lanes, cand = move(lanes), move(cand)
    consts = kernels.FlightConsts(consts.ints, consts.floats, consts.packed.to(cuda),
                                  consts.coeffs.to(cuda))
    u_step = torch.from_numpy(rng.uniform(1e-9, 1, n).astype(np.float32)).to(cuda)
    u_int = torch.from_numpy(rng.uniform(1e-6, 1, n).astype(np.float32)).to(cuda)
    ref = clone_lanes(lanes)
    rem_k = torch.tensor(2 * n, dtype=torch.int32, device=cuda)
    rem_r = rem_k.clone()
    cnt_k = torch.zeros(2, dtype=torch.int32, device=cuda)
    cnt_r = cnt_k.clone()
    kernels.flight_step(lanes, cand, u_step, u_int, consts, rem_k, cnt_k)
    kernels.flight_step_reference(ref, cand, u_step, u_int, consts, rem_r, cnt_r)
    for name, a, b in zip(FlightLanes._fields, lanes, ref):
        if a.dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=name)
        else:
            assert int((a != b).sum()) <= 2, name
    assert abs(int(rem_k) - int(rem_r)) <= 2


# ---------------------------------------------------------------------------
# Philox in a kernel: exact, so every word must equal the plain version's
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_philox_kernel_on_card(cuda):
    vectors = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    counters = torch.tensor([v[0] for v in vectors], dtype=torch.int64, device=cuda)
    keys = torch.tensor([v[1] for v in vectors], dtype=torch.int64, device=cuda)
    assert kernels.philox_words(counters, keys).tolist() == [list(v[2]) for v in vectors]
    rng = np.random.default_rng(0)
    n = 1 << 20
    counters = torch.from_numpy(rng.integers(0, 1 << 32, (n, 4), dtype=np.int64)).to(cuda)
    keys = torch.from_numpy(rng.integers(0, 1 << 32, (n, 2), dtype=np.int64)).to(cuda)
    want = torch.stack(philox4x32_10(counters.unbind(1), keys.unbind(1)), dim=1)
    assert torch.equal(kernels.philox_words(counters, keys), want)
    # the block of an iteration, as the stepwise path draws it
    before = kernels.launch_counts["philox_block"]
    key = make_key(3, 1, 4)
    got = kernels.philox_block(key, 12_345, 76, 10_007, cuda)
    assert kernels.launch_counts["philox_block"] == before + 1
    assert torch.equal(got, philox_bits(key, 12_345, 76, 10_007, cuda))
    assert torch.equal(got.cpu(), philox_bits(key, 12_345, 76, 10_007, "cpu"))


# ---------------------------------------------------------------------------
# the phase kernels of the outer iteration, each against its plain version on
# a state captured before the 5th iteration (the limits of chip_smoke.py:
# every integer and flag field equal and floats within 1e-6 * (1 + |value|)
# on all lanes but at most 1e-4 of them; image sums within 1e-5 relative)
# ---------------------------------------------------------------------------
SLAB_CONFIG = transport.EngineConfig(n_lanes=1 << 14, max_virtual_trips=8)
PHASE_CONFIGS = {
    "production": transport.production_engine_config(n_lanes=1 << 14),
    "slab": SLAB_CONFIG,
}
#: the engine's v4 options on the production configuration, alone and together
OPTIONS = {
    "alias": dict(spectrum_mode="alias"), "table": dict(sigma_mode="table"),
    "rita": dict(rayleigh_mode="rita"), "dose": dict(tally_dose=True),
    "all": dict(spectrum_mode="alias", sigma_mode="table", rayleigh_mode="rita",
                tally_dose=True),
}
PHASE_CONFIGS.update({name: transport.production_engine_config(n_lanes=1 << 14, **ov)
                      for name, ov in OPTIONS.items()})
DOSE_TOL = 1e-5  # of the plain version's largest voxel / material sum (float32 atomics)


def _phase_steps(C):
    """The phases of one outer iteration in the order they run, as
    ``(kernel name, call(phases, state))``; the last flight_resolve carries
    the tally."""
    R = max(1, C.config.n_resolves)
    steps = [("refill", lambda ph, st: ph.refill(C, st, C.rows.refill, True))]
    for r in range(R):
        steps.append(("flight_resolve",
                      lambda ph, st, r=r: ph.flight_resolve(C, st, r, r == R - 1)))
        if r < R - 1:
            steps.append(("refill", lambda ph, st, r=r: ph.refill(C, st, C.rows.mid[r], False)))
    return steps


def _launches(st, kernel):
    return int(st.ctrl[kernels.PHASE_LAUNCH_WORDS[kernel]])


def _assert_phase_matches(got, want, n, name):
    bad, rel, words_equal, image_rel = state_diff(got, want)
    assert int(bad.sum()) <= n // 10_000, (name, int(bad.sum()))
    assert rel <= 1e-6, (name, rel)
    assert words_equal or int(bad.sum()) > 0, name
    assert image_rel <= 1e-5, (name, image_rel)


def _assert_dose_matches(got, want):
    for name in ("voxel_dose", "material_dose"):
        g, w = getattr(got, name).double(), getattr(want, name).double()
        assert float((g - w).abs().max()) <= DOSE_TOL * max(float(w.abs().max()), 1.0), name


def _check_phase(cuda, kernel, config_name, remaining=None):
    config = PHASE_CONFIGS[config_name]
    scene = slab_engine(cuda, config, mono=config_name == "slab")
    C, st, _ = state_in_mid_run(scene, config, 10_000_000, seed=11)
    n = config.n_lanes
    if remaining is not None:
        st.ctrl[transport.CTRL_REMAINING] = remaining
    seen = 0
    for name, call in _phase_steps(C):
        got, want = st.clone(), st.clone()
        for dose in (got.voxel_dose, got.material_dose, want.voxel_dose, want.material_dose):
            if dose is not None:  # tally_dose: each side's sums of this launch's deposits
                dose.zero_()
        call(transport._engine_phases(), got)
        call(transport._plain_phases(), want)
        torch.cuda.synchronize()
        if name == kernel:
            seen += 1
            # the launches that did work count themselves on the device
            assert _launches(got, name) > _launches(st, name)
            _assert_phase_matches(got, want, n, name)
            if config.tally_dose:
                _assert_dose_matches(got, want)
        st = want
    assert seen > 0
    assert int(st.ctrl[transport.CTRL_ITERATION]) == 5  # the tally rode on the last launch


@pytest.mark.gpu
@pytest.mark.parametrize("config_name", ["production", "slab"])
def test_refill_kernel_on_card(cuda, config_name):
    _check_phase(cuda, "refill", config_name)


@pytest.mark.gpu
def test_refill_kernel_ordered_budget_tail_on_card(cuda):
    """A budget shorter than the dead lanes starts histories in lane order."""
    _check_phase(cuda, "refill", "production", remaining=1_500)


@pytest.mark.gpu
@pytest.mark.parametrize("config_name", ["production", "slab"])
def test_flight_resolve_kernel_on_card(cuda, config_name):
    _check_phase(cuda, "flight_resolve", config_name)


@pytest.mark.gpu
@pytest.mark.parametrize("config_name", ["production", "slab"])
def test_tally_kernel_on_card(cuda, config_name):
    """The tally as a launch of its own, on the state the last flight_resolve
    of an iteration leaves when it does not carry the tally."""
    config = PHASE_CONFIGS[config_name]
    scene = slab_engine(cuda, config, mono=config_name == "slab")
    C, st, _ = state_in_mid_run(scene, config, 10_000_000, seed=11)
    plain = transport._plain_phases()
    for name, call in _phase_steps(C)[:-1]:
        call(plain, st)
    plain.flight_resolve(C, st, max(1, config.n_resolves) - 1, False)
    got, want = st.clone(), st.clone()
    transport.tally_phase(C, got)
    transport.tally_phase_reference(C, want)
    torch.cuda.synchronize()
    assert _launches(got, "tally") == _launches(st, "tally") + 1
    _assert_phase_matches(got, want, config.n_lanes, "tally")
    assert float(want.image.sum()) > float(st.image.sum())


@pytest.mark.gpu
@pytest.mark.parametrize("config_name", list(OPTIONS))
@pytest.mark.parametrize("kernel", ["refill", "flight_resolve"])
def test_option_variants_on_card(cuda, kernel, config_name):
    """The refill (alias) and flight_resolve (table sigma, RITA, dose)
    instantiations of each v4 option, alone and together, against their
    plain versions; the dose tallies within 1e-5 of the plain sums."""
    _check_phase(cuda, kernel, config_name)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(OPTIONS))
def test_whole_engine_options_on_card(cuda, name):
    """The whole engine under each option: the recorded graph of the
    option's instantiations against the plain version on the card, as
    test_whole_engine_on_card_matches_plain_version. With the dose: the
    voxel tallies (small sums each) within 1e-4 of the plain run's total,
    and on each side the material total within 1e-3 of the float64 sum of
    its voxel tallies. Over a whole run the material sums pass 2^24 ulps
    of their deposits, where float32 stagnates and the two orders (lane
    order in the plain version's scatter-add, block partials in the kernel)
    part by up to ~1e-3 (the first card run of this test: 1.6e-3 over both
    columns); one launch's are held to 1e-5 in test_option_variants_on_card."""
    config = transport.production_engine_config(n_lanes=1 << 14, **OPTIONS[name])
    scene = slab_engine(cuda, config, mono=False)
    runs = _run_both(cuda, scene, config, 1_000_000, seed=5)
    _assert_same_run(*runs, 1_000_000)
    if config.tally_dose:
        (_, ex_k), (_, ex_p) = runs
        vox_k, vox_p = ex_k["voxel_dose"].double(), ex_p["voxel_dose"].double()
        assert torch.isfinite(vox_k).all()
        assert float((vox_k - vox_p).abs().sum()) <= 1e-4 * float(vox_p.sum())
        for ex, vox in ((ex_k, vox_k), (ex_p, vox_p)):
            mat = ex["material_dose"].double()
            assert torch.isfinite(mat).all() and float(mat[:, 1].sum()) > 0
            assert abs(float(mat[:, 0].sum()) - float(vox.sum())) <= 1e-3 * float(vox.sum())


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["production", "v3"])
def test_phases_do_nothing_once_the_loop_has_ended_on_card(cuda, name):
    config = {**PHASE_CONFIGS, **V3_CONFIGS}[name]
    C, st, _ = state_in_mid_run(slab_engine(cuda, config, mono=False), config, 10_000_000, 11)
    st.ctrl[transport.CTRL_RUN] = 0
    got = st.clone()
    transport.outer_iteration(transport._engine_phases(), C, got)
    transport.tally_phase(C, got)
    torch.cuda.synchronize()
    bad, rel, words_equal, image_rel = state_diff(got, st)
    assert int(bad.sum()) == 0 and rel == 0.0 and words_equal and image_rel == 0.0
    assert torch.equal(got.ctrl, st.ctrl)  # not even a launch counted


def _run_both(cuda, scene, config, n_histories, seed, **kwargs):
    """run_projection (the recorded graph of the phase kernels) and
    run_projection_reference (their plain versions) on the card, from the
    same key."""
    tables, woodcock, volume, src, det, n_pix = scene
    return [
        run(tables, woodcock, volume, src, det, n_histories, make_key(seed),
            n_pix, n_pix, config=config, return_stats=True, device=cuda, **kwargs)
        for run in (transport.run_projection, transport.run_projection_reference)
    ]


def _assert_same_run(kernel_run, plain_run, n_histories, count_slack=0.0):
    """Iterations equal; integer counters equal, or within ``count_slack``
    relative (at least 2) where the two sides' transcendentals round
    differently; tallied energy and channel sums within 1e-6 / 1e-4."""
    (image_k, ex_k), (image_p, ex_p) = kernel_run, plain_run
    assert ex_k["iterations"] == ex_p["iterations"]
    counts_k, counts_p = ex_k["counts"].cpu().numpy(), ex_p["counts"].cpu().numpy()
    ints = [0, 2, 3, 4, 5, 6, 7]
    slack = np.maximum(2, count_slack * counts_p[ints]) if count_slack else 0
    assert (np.abs(counts_k[ints] - counts_p[ints]) <= slack).all(), (counts_k, counts_p)
    assert counts_k[5] + counts_k[6] == n_histories
    np.testing.assert_allclose(counts_k[8], counts_p[8], rtol=1e-4 if count_slack else 1e-6)
    sums_k = image_k.double().sum(dim=(1, 2)).cpu().numpy()
    sums_p = image_p.double().sum(dim=(1, 2)).cpu().numpy()
    np.testing.assert_allclose(sums_k, sums_p, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["slab", "odd_width"])
def test_whole_engine_on_card_matches_plain_version(cuda, name):
    """1e6 histories, one seed: the card's path and the plain version on the
    card use the same random words, so the iteration count and every integer
    counter agree and the channel sums agree to 1e-4 (the golden slab's
    scene and configuration; the production configuration at a lane count
    that fills no whole block, under the default spectrum)."""
    config = SLAB_CONFIG if name == "slab" else transport.production_engine_config(n_lanes=10_007)
    scene = slab_engine(cuda, config, mono=name == "slab")
    _assert_same_run(*_run_both(cuda, scene, config, 1_000_000, seed=5), 1_000_000)


@pytest.mark.gpu
def test_chunked_carry_on_card_matches_plain_version(cuda):
    """Two chunks linked by the survivor carry (pending events, stashed
    records and parked lanes cross the chunk boundary), the second drained."""
    config = PHASE_CONFIGS["production"]
    scene = slab_engine(cuda, config, mono=False)
    first = _run_both(cuda, scene, config, 300_000, seed=6, return_carry=True)
    _assert_same_run(*first, 300_000)
    carry_k, carry_p = first[0][1]["carry"], first[1][1]["carry"]
    assert int(carry_p.alive.sum()) > 1000
    for name, a, b in zip(carry_k._fields, carry_k, carry_p):
        assert torch.equal(a, b), name
    tables, woodcock, volume, src, det, n_pix = scene
    second = [
        run(tables, woodcock, volume, src, det, 200_000, make_key(7), n_pix, n_pix,
            config=config, return_stats=True, carry_in=carry, device=cuda)
        for run, carry in ((transport.run_projection, carry_k),
                           (transport.run_projection_reference, carry_p))
    ]
    _assert_same_run(*second, 200_000)


@pytest.mark.gpu
def test_graph_eager_and_cpu_paths_agree_on_card(cuda):
    """One key, three ways: the recorded graph (k = 16), the eager loop with
    a host read per iteration (k = 1), both on the card, and the plain
    versions on the CPU. The generator is exact, so all three use the same
    random words. The graph and the eager path run the same kernels and
    differ only by the order of the image's atomic adds: every integer
    counter is equal. The CPU's sin / log / exp round differently from the
    card's, which may move a handful of events across a threshold: its
    counters agree within 2 or 1e-5 relative, the channel sums to 1e-4.

    Launches are counted twice: on the device those that did work (two per
    kernel and iteration, however they were enqueued), and where they are
    launched or replayed those handed to the card (the graph's last replay
    runs past the end of the loop, so it enqueues more than did work)."""
    config = transport.production_engine_config(n_lanes=1 << 14)
    n = 300_000
    runs, did_work, enqueued = [], [], []
    for dev, k in ((cuda, None), (cuda, 1), ("cpu", None)):
        tables, woodcock, volume, src, det, n_pix = slab_engine(dev, config, mono=False)
        kernels.reset_launch_counts()
        runs.append(transport.run_projection(
            tables, woodcock, volume, src, det, n, make_key(21), n_pix, n_pix, config=config,
            return_stats=True, device=dev, iterations_per_read=k))
        did_work.append(dict(kernels.launch_counts))
        enqueued.append(dict(kernels.enqueued_counts))
    iterations, per_read = runs[0][1]["iterations"], transport.ITERATIONS_PER_READ
    replayed = -(-iterations // per_read) * per_read
    for name in ("refill", "flight_resolve"):
        assert did_work[0][name] == did_work[1][name] == 2 * iterations
        assert enqueued[0][name] == 2 * replayed and enqueued[1][name] == 2 * iterations
    assert sum(did_work[2].values()) == 0 and sum(enqueued[2].values()) == 0
    _assert_same_run(runs[0], runs[1], n)
    _assert_same_run(runs[0], runs[2], n, count_slack=1e-5)
    assert runs[0][1]["iterations"] % transport.ITERATIONS_PER_READ  # ran past the end


@pytest.mark.gpu
def test_workspace_and_graph_across_views_and_chunks_on_card(cuda):
    """One workspace (one recorded graph) over two views of two chunks each
    equals calls that build their own workspace and loop eagerly."""
    config = transport.production_engine_config(n_lanes=1 << 14)
    views = [slab_engine(cuda, config, mono=False, angle=a) for a in (270.0, 200.0)]
    tables, woodcock, volume = views[0][:3]
    n_pix = views[0][5]
    shared = transport.EngineWorkspace(tables, woodcock, volume, n_pix, n_pix, config, cuda)
    for v, (_, _, _, src, det, _) in enumerate(views):
        carries = [None, None]
        for chunk, n in enumerate((200_000, 150_000)):
            last = chunk == 1
            out = []
            for j, (ws, k) in enumerate(((shared, None), (None, 1))):
                image, extras = transport.run_projection(
                    tables, woodcock, volume, src, det, n, make_key(50, v, chunk), n_pix,
                    n_pix, config=config, return_stats=True, carry_in=carries[j],
                    return_carry=not last, device=cuda, workspace=ws, iterations_per_read=k)
                if not last:
                    carries[j] = transport.LaneState(*(t.clone() for t in extras["carry"]))
                out.append((image.clone(), extras))
            _assert_same_run(*out, n)
            if not last:
                for name, a, b in zip(carries[0]._fields, *carries):
                    assert torch.equal(a, b), name
    assert len(shared.graphs) == 1


# ---------------------------------------------------------------------------
# the engine's v3 body (resolve_inplace=False): compact, tally_compacted and
# resolve_compacted against their plain versions (the limits of the phase
# kernels above), and the whole v3 engine as graph against plain
# ---------------------------------------------------------------------------
V3_CONFIGS = {
    "v3": transport.production_engine_config(n_lanes=1 << 14, resolve_inplace=False),
    "v3_analytic": transport.production_engine_config(
        n_lanes=1 << 14, resolve_inplace=False, tau_table=False),
    "v3_dose": transport.production_engine_config(
        n_lanes=1 << 14, resolve_inplace=False, tally_dose=True),
    # the event budget (its floor of 1,024) and the doubles budget (32) bind
    "v3_starved": transport.production_engine_config(
        n_lanes=1 << 14, resolve_inplace=False, event_fraction=0.02, doubles_fraction=1e-9),
    "v3_slab": dataclasses.replace(SLAB_CONFIG, resolve_inplace=False),
}


@pytest.mark.gpu
@pytest.mark.parametrize("m,budget,share", [
    (1, 4, 1.0), (1_000, 300, 0.5), (70_001, 50_000, 0.5), (4_096, 8_192, 0.3),
    (5_000, 100, 0.0), (65_536, 22_937, 0.3), (22_937, 3_822, 0.1),
    (1 << 20, 367_001, 0.35), (1 << 20, (1 << 20) + 77, 0.5), (1 << 20, 0, 0.5),
    (65_536, 0, 0.3), (1 << 20, 5_000, 0.0)])
def test_compact_kernel_on_card(cuda, m, budget, share):
    """Over budget, under budget, a budget past the mask's length, a budget
    of 0, an empty mask, the production event and Rayleigh batches, 2^20
    entries: idx and ranks equal to the plain version's, one launch counted
    (the single-pass scan)."""
    rng = np.random.default_rng(m + budget)
    mask = torch.from_numpy(rng.random(m) < share).to(cuda)
    kernels.reset_launch_counts()
    idx, order = kernels.compact(mask, budget, m)
    want_idx, want_order = transport.compact_indices(mask, budget, m)
    torch.cuda.synchronize()
    assert torch.equal(idx, want_idx) and torch.equal(order, want_order)
    assert kernels.launch_counts["compact"] == 1


@pytest.mark.gpu
def test_compact_epochs_without_a_reset_on_card(cuda):
    """Many launches on one scan scratch (the wrapper keeps one per grid),
    then a CUDA graph of 16 compactions on the engine's control words,
    replayed twice with new masks in between: every launch's idx and ranks
    equal the plain version's, though the scratch is never reset."""
    m, budget = 70_001, 22_937
    rng = np.random.default_rng(7)
    for k in range(40):
        mask = torch.from_numpy(rng.random(m) < rng.random()).to(cuda)
        idx, order = kernels.compact(mask, budget // (1 + k % 3), m)
        want_idx, want_order = transport.compact_indices(mask, budget // (1 + k % 3), m)
        assert torch.equal(idx, want_idx) and torch.equal(order, want_order), k
    masks = torch.zeros((16, m), dtype=torch.uint8, device=cuda)
    alive = torch.ones(m, dtype=torch.uint8, device=cuda)
    idx = torch.zeros((16, budget), dtype=torch.int32, device=cuda)
    order = torch.zeros((16, m), dtype=torch.int32, device=cuda)
    ctrl = torch.zeros(32, dtype=torch.int32, device=cuda)
    ctrl[transport.CTRL_RUN] = 1
    scan = torch.zeros(kernels.scan_words(-(-m // kernels.COMPACT_BLOCK)), dtype=torch.int64,
                       device=cuda)
    kernels.load_kernels(("compact",))
    stream = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for k in range(16):
            kernels.launch_compact(masks[k], alive, scan, budget // (1 + k % 3), m, idx[k],
                                   order[k], ctrl, stream.cuda_stream)
    for replay in range(2):
        masks.copy_(torch.from_numpy(rng.random((16, m)) < rng.random((16, 1))))
        graph.replay()
        torch.cuda.synchronize()
        for k in range(16):
            b = budget // (1 + k % 3)
            want_idx, want_order = transport.compact_indices(masks[k].bool(), b, m)
            assert torch.equal(idx[k, :b], want_idx) and torch.equal(order[k], want_order), (
                replay, k)
    assert int(ctrl[kernels.PHASE_LAUNCH_WORDS["compact"]]) == 32
    assert int(scan[0]) == 32 * (scan.shape[0] - 1)  # every launch took a ticket a block


@pytest.mark.gpu
def test_v3_graph_replays_without_a_reset_on_card(cuda):
    """The engine's recorded graph of 16 v3 iterations replayed twice on one
    state (its three scans' scratch never reset) against 16 plain
    iterations after each replay: every compaction inside ranked alike, so
    the lanes, the counters and the control words agree (the limits of the
    phase kernels above)."""
    config = V3_CONFIGS["v3"]
    C, st, _ = state_in_mid_run(slab_engine(cuda, config, mono=False), config, 10_000_000, 11)
    got, want = st.clone(), st.clone()
    phases = transport._engine_phases()
    kernels.prepare_phase_launches(C, got)
    kernels.load_kernels(kernels.phase_entries(config))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(16):
            transport.outer_iteration(phases, C, got)
    for replay in range(2):
        graph.replay()
        for _ in range(16):
            transport.outer_iteration(transport._plain_phases(), C, want)
        torch.cuda.synchronize()
        _assert_phase_matches(got, want, config.n_lanes, f"replay {replay}")
        assert int(got.ctrl[transport.CTRL_ITERATION]) == 4 + 16 * (replay + 1)
    scan = got.launch_args.compact.tally_scan  # 2 sub-phases x 32 iterations
    assert int(scan[0]) == 64 * -(-config.n_lanes // kernels.TALLY_BLOCK)


@pytest.mark.gpu
@pytest.mark.parametrize("config_name", list(V3_CONFIGS))
def test_v3_kernels_on_card(cuda, config_name):
    """Each launch group of a v3 iteration on the state before the 5th
    iteration, kernel against plain version; each launch counted on the
    device; with the dose the tallies within 1e-5 of the plain sums."""
    from torch_kernel_inputs import v3_phase_steps

    config = V3_CONFIGS[config_name]
    scene = slab_engine(cuda, config, mono=config_name == "v3_slab")
    C, st, _ = state_in_mid_run(scene, config, 10_000_000, seed=11)
    n = config.n_lanes
    seen = set()
    for name, engine, plain in v3_phase_steps(C):
        got, want = st.clone(), st.clone()
        for dose in (got.voxel_dose, got.material_dose, want.voxel_dose, want.material_dose):
            if dose is not None:
                dose.zero_()
        engine(got)
        plain(want)
        torch.cuda.synchronize()
        assert _launches(got, name) > _launches(st, name), name
        _assert_phase_matches(got, want, n, name)
        if config.tally_dose:
            _assert_dose_matches(got, want)
        seen.add(name)
        st = want
    assert seen == {"refill", "flight_resolve", "tally_compacted", "resolve_compacted"}
    assert int(st.ctrl[transport.CTRL_ITERATION]) == 5  # the last resolve ended it
    if config_name == "v3_starved":
        assert bool(st.lanes.pending.any())  # events past the budget wait


#: the fused tally's cases: the production width at the event budget and at
#: a tenth of it, and the slab at 4 flights a sub-phase with 32 doubles' slots
#: (more doubles than slots: the overflow carry; more events than slots too)
TALLY_CASES = {
    "event_budget": (transport.production_engine_config(
        n_lanes=1 << 16, resolve_inplace=False), False),
    "tenth_of_it": (transport.production_engine_config(
        n_lanes=1 << 16, resolve_inplace=False, event_fraction=0.035), False),
    "doubles_past_budget": (dataclasses.replace(
        SLAB_CONFIG, resolve_inplace=False, doubles_fraction=1e-9), True),
}


def _doubles(C, st):
    L = st.lanes
    _, hit = transport._tally_pixel(L.px, L.py, L.pz, L.dx, L.dy, L.dz, C.detector,
                                    C.n_pixels_x, C.n_pixels_z)
    return int((L.stash_valid & (L.stash_idx < 4 * C.n_pixels) & L.escaped & hit).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(TALLY_CASES))
def test_v3_tally_kernel_on_card(cuda, case):
    """The fused ``tally_compacted`` launch against its plain composition
    (the tally, then ``compact_indices`` of the pending, live lanes) at each
    sub-phase of the iteration after 4: every lane field, the events'
    slots, the counters and the control words bit-equal; the image sums
    within 1e-5 and the tallied energy within 1e-12 relative; one launch
    counted on the device. Where the doubles' budget binds, a tally sees
    more doubles than its slots."""
    from torch_kernel_inputs import v3_phase_steps

    config, binds = TALLY_CASES[case]
    scene = slab_engine(cuda, config, mono=False)
    C, st, _ = state_in_mid_run(scene, config, 10_000_000, seed=13)
    most, tallies = 0, 0
    for name, engine, plain in v3_phase_steps(C):
        if name == "tally_compacted":
            most = max(most, _doubles(C, st))
            got, want = st.clone(), st.clone()
            engine(got)
            plain(want)
            torch.cuda.synchronize()
            assert _launches(got, name) == _launches(st, name) + 1
            for field, a, b in zip(FlightLanes._fields, got.lanes, want.lanes):
                assert torch.equal(a, b), (case, field)
            assert torch.equal(got.events_idx, want.events_idx), case
            assert torch.equal(got.counters, want.counters), case
            assert torch.equal(got.ctrl[:11], want.ctrl[:11]), case
            bad, rel, words_equal, image_rel = state_diff(got, want)
            assert words_equal and image_rel <= 1e-5, (case, image_rel)
            assert abs(float(got.energy) - float(want.energy)) <= 1e-12 * float(want.energy)
            tallies += 1
            st = want
        else:
            plain(st)
    assert tallies == max(1, config.n_resolves)
    assert (most > config.doubles_lanes) == binds, (case, most, config.doubles_lanes)


@pytest.mark.gpu
@pytest.mark.parametrize("config_name", ["v3", "v3_analytic", "v3_starved", "v3_slab"])
def test_whole_engine_v3_on_card(cuda, config_name):
    """The v3 engine from one key as the recorded graph and as the plain
    version on the card: iterations and integer counters equal, channel
    sums within 1e-4; every history started once."""
    config = V3_CONFIGS[config_name]
    scene = slab_engine(cuda, config, mono=config_name == "v3_slab")
    _assert_same_run(*_run_both(cuda, scene, config, 1_000_000, seed=5), 1_000_000)


# ---------------------------------------------------------------------------
# the fast-scan / FDK slice: primary_trace and backproject against their plain
# versions on the card (same operation sequence, -fmad=false: bit-equal is
# expected; the limits are those of chip_smoke.py)
# ---------------------------------------------------------------------------
def _primary_scene(device, shape=(64, 64, 64), spacing_mm=4.0):
    from cbctmc_tpu_torch.engine.ct import ScanGeometry, build_scan
    from cbctmc_tpu_torch.geometry.phantoms import CatPhan604Geometry
    from cbctmc_tpu_torch.physics.materials import default_material_set

    ts = default_material_set()
    phantom = CatPhan604Geometry(shape=shape, image_spacing=(spacing_mm,) * 3)
    mats = np.ascontiguousarray(np.rot90(phantom.materials, k=3, axes=(0, 1)))
    dens = np.ascontiguousarray(np.rot90(phantom.densities, k=3, axes=(0, 1)))
    volume, _ = transport.make_scene(ts, mats.astype(np.int32) - 1, dens,
                                     (spacing_mm / 10.0,) * 3, device=device)
    size = shape[0] * spacing_mm / 10.0
    geom = ScanGeometry(
        n_pixels_x=192, n_pixels_z=80, detector_size_x=71.7024, detector_size_z=29.7984,
        sdd=150.0, sad=100.0, aperture_phi1=1.4817, aperture_phi2=13.442, aperture_theta=-1.0,
        source_position_0=(size / 2, size / 2 - 100.0, size / 2),
    )
    source, detector = build_scan(geom, [270.0, 37.0], device=device)
    return ts, volume, geom, source, detector


@pytest.mark.gpu
@pytest.mark.parametrize("repack", [False, True])
def test_primary_trace_kernel_on_card(cuda, repack):
    from cbctmc_tpu_torch.engine import primary

    ts, volume, geom, source, detector = _primary_scene(cuda)
    pv = (primary.uniform_clearance_volume(volume, device=cuda) if repack
          else primary.primary_volume(volume, device=cuda))
    mats = primary.trace_materials(pv, ts)
    for i in range(2):
        src = source.position[i].tolist()
        dirs = torch.from_numpy(primary._detector_ray_dirs(
            geom, np.asarray(src, np.float32), detector, i)).to(cuda)
        n = dirs.shape[0]
        steps_k = torch.empty(n, dtype=torch.int32, device=cuda)
        steps_p = torch.empty(n, dtype=torch.int32, device=cuda)
        before = kernels.launch_counts["primary_trace"]
        got = primary.primary_trace(pv, src, dirs, mats, primary.max_trace_steps(pv), steps_k)
        assert kernels.launch_counts["primary_trace"] == before + 1
        want = primary.primary_trace_reference(pv, src, dirs, mats, primary.max_trace_steps(pv),
                                               steps_p)
        torch.cuda.synchronize()
        assert torch.equal(steps_k, steps_p)
        assert float(((got - want).abs() / (1 + want.abs())).max()) <= 1e-6
        assert int((got != want).any(dim=1).sum()) <= n // 10_000


@pytest.mark.gpu
def test_uniform_clearance_and_primary_images_on_card(cuda):
    from cbctmc_tpu_torch.engine import primary
    from cbctmc_tpu_torch.physics.spectrum import default_spectrum

    ts, volume, geom, source, detector = _primary_scene(cuda)
    on_card = primary.uniform_clearance_volume(volume, device=cuda)
    on_cpu = primary.uniform_clearance_volume(volume, device="cpu")
    assert torch.equal(on_card.packed.cpu(), on_cpu.packed)
    assert on_card.present == on_cpu.present
    mean, var = primary.deterministic_primary(on_card, ts, default_spectrum(), geom, source,
                                              detector, projection_index=1, device=cuda)
    ref_mean, ref_var = primary.deterministic_primary_reference(
        on_card, ts, default_spectrum(), geom, source, detector, projection_index=1, device=cuda)
    assert np.abs(mean - ref_mean).max() <= 1e-6 * np.abs(ref_mean).max()
    assert np.abs(var - ref_var).max() <= 1e-6 * np.abs(ref_var).max()
    assert (mean > 0).mean() > 0.2


@pytest.mark.gpu
def test_backproject_kernel_on_card(cuda):
    from cbctmc_tpu_torch.recon import fdk
    from cbctmc_tpu_torch.recon.geometry import ConeBeamGeometry, VolumeGrid

    geom = ConeBeamGeometry(n_pixels_u=256, n_pixels_v=96, pixel_size_u=1.552,
                            pixel_size_v=1.552, detector_offset_u=-159.856)
    grid = VolumeGrid(shape=(116, 116, 62), spacing=(4.0, 4.0, 4.0))
    rng = np.random.default_rng(4)
    angles = np.sort(rng.uniform(0, 360, 24))
    filtered = torch.from_numpy(rng.normal(0, 1, (24, 96, 256)).astype(np.float32)).to(cuda)
    views = torch.from_numpy(fdk.view_geometry(geom, angles)).to(cuda)
    bp = fdk.BackprojectGeometry(geom, grid, len(angles))
    start = torch.from_numpy(rng.normal(0, 1, grid.shape).astype(np.float32)).to(cuda)
    got, want = start.clone(), start.clone()
    before = kernels.launch_counts["backproject"]
    fdk.backproject_into(got, filtered, views, bp)
    assert kernels.launch_counts["backproject"] == before + 1
    fdk.backproject_into_reference(want, filtered, views, bp)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


@pytest.mark.gpu
def test_fdk_reconstruct_on_card_matches_cpu(cuda):
    from cbctmc_tpu_torch.recon import fdk
    from cbctmc_tpu_torch.recon.geometry import ConeBeamGeometry, VolumeGrid

    geom = ConeBeamGeometry(sad=400.0, sdd=600.0, n_pixels_u=128, n_pixels_v=8,
                            pixel_size_u=4.0, pixel_size_v=4.0, detector_offset_u=0.0)
    rng = np.random.default_rng(5)
    proj = rng.uniform(0, 2, (36, 8, 128)).astype(np.float32)
    angles = np.arange(0.0, 360.0, 10.0) + 270.0
    grid = VolumeGrid(shape=(48, 48, 4), spacing=(2.0, 2.0, 2.0))
    kw = dict(grid=grid, water_precorrection=[0.05, 0.9, 0.02], view_chunk=10)
    got = fdk.fdk_reconstruct(proj, geom, angles, device=cuda, **kw)
    want = fdk.fdk_reconstruct(proj, geom, angles, device="cpu", **kw)
    # cuFFT and the CPU's FFT round differently
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# ---------------------------------------------------------------------------
# the edges of the redesigned kernels: backproject's column segments and x-y
# tiles, primary_trace's rays with their sums and tables in shared memory;
# every output bit-equal to the plain version
# ---------------------------------------------------------------------------
def _small_panel_backprojection(device, grid_shape, n_views, seed):
    from cbctmc_tpu_torch.recon import fdk
    from cbctmc_tpu_torch.recon.geometry import ConeBeamGeometry, VolumeGrid

    # a panel whose field of view (~66 mm at the isocentre) is narrower than
    # the 8 mm grid: most voxels fall off the detector in most views
    geom = ConeBeamGeometry(n_pixels_u=64, n_pixels_v=24, pixel_size_u=1.552,
                            pixel_size_v=1.552, detector_offset_u=-20.0)
    grid = VolumeGrid(shape=grid_shape, spacing=(8.0, 8.0, 3.0))
    rng = np.random.default_rng(seed)
    angles = np.sort(rng.uniform(0, 360, n_views))
    filtered = torch.from_numpy(
        rng.normal(0, 1, (n_views, 24, 64)).astype(np.float32)).to(device)
    views = torch.from_numpy(fdk.view_geometry(geom, angles)).to(device)
    bp = fdk.BackprojectGeometry(geom, grid, n_views)
    start = torch.from_numpy(rng.normal(0, 1, grid_shape).astype(np.float32)).to(device)
    return fdk, filtered, views, bp, start


@pytest.mark.gpu
@pytest.mark.parametrize("grid_shape", [(37, 29, 13), (33, 17, 250)])
@pytest.mark.parametrize("n_views", [1, 64])
def test_backproject_kernel_edges_on_card(cuda, grid_shape, n_views):
    """nx and ny not multiples of the tile, nz below the z segment or not a
    multiple of it, one view and a full chunk, voxels off the detector."""
    fdk, filtered, views, bp, start = _small_panel_backprojection(cuda, grid_shape, n_views, 6)
    got, want = start.clone(), start.clone()
    before = kernels.launch_counts["backproject"]
    fdk.backproject_into(got, filtered, views, bp)
    assert kernels.launch_counts["backproject"] == before + 1
    fdk.backproject_into_reference(want, filtered, views, bp)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    # some voxels fell off the detector in every view, some did not
    assert bool((want == start).any()) and bool((want != start).any())


@pytest.mark.gpu
def test_backproject_kernel_repeats_on_card(cuda):
    fdk, filtered, views, bp, start = _small_panel_backprojection(cuda, (33, 17, 250), 64, 7)
    first, second = start.clone(), start.clone()
    fdk.backproject_into(first, filtered, views, bp)
    fdk.backproject_into(second, filtered, views, bp)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _word_scene(device, shape=(24, 20, 16), vs=0.4, seed=0):
    """A PrimaryVolume of random words (every raw material 0..31, clearance
    levels 0..3, random densities) with all 32 materials as columns of L,
    and a source outside the box whose y and z lie on voxel planes."""
    from cbctmc_tpu_torch.engine import primary

    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    mat = rng.integers(0, 32, n).astype(np.uint32)
    mat[:32] = np.arange(32, dtype=np.uint32)
    level = rng.integers(0, 4, n).astype(np.uint32)
    den = rng.integers(1, 1 << 21, n).astype(np.uint32)
    words = (mat << 27) | (level << 24) | den
    pv = primary._primary_volume(
        torch.from_numpy(words.view(np.int32)), shape, torch.full((3,), vs),
        torch.tensor(1.0 / (1 << 20)), device)
    assert pv.present == tuple(range(32))
    mats = primary.TraceMaterials(
        remap=torch.arange(32, dtype=torch.int32, device=device),
        inv_rho=torch.from_numpy(rng.uniform(0.3, 3.0, 32).astype(np.float32)).to(device))
    v32 = np.float32(vs)
    src = [-2.0, float(np.float32(8) * v32), float(np.float32(6) * v32)]
    return primary, pv, mats, src


def _word_scene_rays(src, shape, vs, n, seed):
    """n unit directions from src: most toward random points of the box, a
    tenth away from it (they miss), and the first along +x exactly (through
    the voxel planes y = 8 vs, z = 6 vs: the reference's crawl)."""
    rng = np.random.default_rng(seed)
    box = np.asarray(shape, np.float64) * vs
    d = rng.uniform(0.0, 1.0, (n, 3)) * box - np.asarray(src, np.float64)
    d[: n // 10] *= -1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[0] = (1.0, 0.0, 0.0)
    return d.astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("n_rays", [1, 31, 1_197])
def test_primary_trace_kernel_edges_on_card(cuda, n_rays):
    """32 materials (the 5-bit maximum), rays that miss the box, the axis ray
    that crawls to the step cap, ray counts that are not multiples of the
    warp's 32 rays."""
    shape, vs = (24, 20, 16), 0.4
    primary, pv, mats, src = _word_scene(cuda, shape, vs)
    dirs = torch.from_numpy(_word_scene_rays(src, shape, vs, n_rays, 8)).to(cuda)
    cap = primary.max_trace_steps(pv)
    steps_k = torch.full((n_rays,), -1, dtype=torch.int32, device=cuda)
    steps_p = torch.empty_like(steps_k)
    before = kernels.launch_counts["primary_trace"]
    got = primary.primary_trace(pv, src, dirs, mats, cap, steps_k)
    assert kernels.launch_counts["primary_trace"] == before + 1
    want = primary.primary_trace_reference(pv, src, dirs, mats, cap, steps_p)
    torch.cuda.synchronize()
    assert torch.equal(steps_k, steps_p)
    assert torch.equal(got, want)
    assert int(steps_p[0]) == cap  # the axis ray along a voxel plane crawls
    if n_rays > 10:
        assert int((steps_p[1 : n_rays // 10] == 0).sum()) == n_rays // 10 - 1  # misses
        assert int((steps_p > 0).sum()) > n_rays // 2


@pytest.mark.gpu
def test_primary_trace_kernel_repeats_on_card(cuda):
    """Two launches on the same inputs give identical output."""
    shape, vs = (24, 20, 16), 0.4
    primary, pv, mats, src = _word_scene(cuda, shape, vs, seed=1)
    dirs = torch.from_numpy(_word_scene_rays(src, shape, vs, 5_000, 9)).to(cuda)
    cap = primary.max_trace_steps(pv)
    s1 = torch.empty(dirs.shape[0], dtype=torch.int32, device=cuda)
    s2 = torch.empty_like(s1)
    first = primary.primary_trace(pv, src, dirs, mats, cap, s1)
    second = primary.primary_trace(pv, src, dirs, mats, cap, s2)
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(s1, s2)


# ---------------------------------------------------------------------------
# the recon-mc kernels at ragged small sizes: a (37, 29, 13) grid and a
# 33 x 17 panel, neither a multiple of a block
# ---------------------------------------------------------------------------
def _joseph_case(device, seed=8, n_views=3, nu=33, nv=17):
    from cbctmc_tpu_torch.recon import joseph
    from cbctmc_tpu_torch.recon.geometry import ConeBeamGeometry

    shape, spacing = (37, 29, 13), np.array([3.0, 3.0, 4.0])
    geom = ConeBeamGeometry(sad=400.0, sdd=600.0, n_pixels_u=nu, n_pixels_v=nv,
                            pixel_size_u=5.0 * 33 / nu, pixel_size_v=5.0 * 17 / nv,
                            detector_offset_u=-12.0)
    angles = np.array([270.0, 311.7, 95.0])[:n_views]
    sources = geom.source_positions(angles)
    rows = joseph.view_rows(sources, sources + geom.beam_directions(angles) * geom.sdd,
                            geom.u_axes(angles))
    origin = -(np.asarray(shape) - 1) * spacing / 2
    jg = joseph.JosephGeometry(shape, origin, spacing, geom.u_coordinates(),
                               geom.v_coordinates(), (0.0, 0.0, 1.0), 90, 1.4)
    rng = np.random.default_rng(seed)
    vol = torch.from_numpy(rng.random(shape).astype(np.float32)).to(device)
    g = torch.from_numpy(rng.random((n_views, nv, nu)).astype(np.float32)).to(device)
    return joseph, jg, torch.from_numpy(rows).to(device), vol, g


def _joseph_edge_case(device, seed=3):
    """Odd panels (a pixel centre on the beam axis: rays with d = 0 on two
    axes) over a grid whose z face lies 0.3 mm from the sources, rows 0.075
    mm apart: runs cut where the rays leave through that face at shallow
    angles; three views a launch (along y, along x, oblique)."""
    from cbctmc_tpu_torch.recon import joseph

    shape, spacing = (20, 20, 6), np.array([4.0, 4.0, 4.0])
    origin = -(np.asarray(shape) - 1) * spacing / 2
    origin[2] = 0.0
    src = np.array([[0.0, -400.0, 0.3], [400.0, 0.0, 0.3], [283.0, 283.0, 0.3]])
    det = np.array([[0.0, 200.0, 0.3], [-200.0, 0.0, 0.3], [-141.0, -141.0, 0.3]])
    e_u = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [-0.7071, 0.7071, 0.0]])
    pixel_u, pixel_v = (np.arange(65) - 32.0) * 6.0, (np.arange(41) - 40.0) * 0.075
    jg = joseph.JosephGeometry(shape, origin, spacing, pixel_u, pixel_v, (0.0, 0.0, 1.0), 160,
                               2.5)
    rng = np.random.default_rng(seed)
    vol = torch.from_numpy(rng.random(shape).astype(np.float32)).to(device)
    g = torch.from_numpy(rng.random((3, 41, 65)).astype(np.float32)).to(device)
    rows = torch.from_numpy(joseph.view_rows(src, det, e_u)).to(device)
    return joseph, jg, rows, vol, g


@pytest.mark.gpu
def test_joseph_project_kernel_on_card(cuda):
    """Bit-equal to the plain version: the same operations in the same order,
    -fmad=false."""
    joseph, jg, views, vol, _ = _joseph_case(cuda)
    before = kernels.launch_counts["joseph_project"]
    got = joseph.joseph_project(vol, views, jg)
    assert kernels.launch_counts["joseph_project"] == before + 1
    want = joseph.project_one_reference(vol, views, jg)
    torch.cuda.synchronize()
    assert got.shape == (3, 17, 33)
    assert float(want.abs().max()) > 0
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_joseph_splat_kernel_on_card(cuda):
    """atomicAdd sums in no fixed order: 1e-5 of the volume's maximum against
    the plain version; the adjoint identity against joseph_project with the
    bound of tests/test_rooster.py (1e-4), both sums in float64."""
    joseph, jg, views, vol, g = _joseph_case(cuda)
    before = kernels.launch_counts["joseph_splat"]
    got = joseph.joseph_splat(g, views, jg)
    assert kernels.launch_counts["joseph_splat"] == before + 1
    want = joseph.splat_one_reference(g, views, jg)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    ax = joseph.joseph_project(vol, views, jg)
    lhs = float((ax.double() * g.double()).sum())
    rhs = float((vol.double() * got.double()).sum())
    assert abs(lhs - rhs) <= 1e-4 * abs(lhs)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["7x45", "130x65", "edges"])
def test_joseph_kernels_ragged_panels_on_card(cuda, case):
    """Warps of 32 rows of a column and blocks of 4 columns (csrc/joseph.cuh)
    on panels that are not whole blocks, 3 views a launch, each ray's march
    cut to its run inside: the projection bit-equal to the plain version
    (which runs every step), the splat within 1e-5 of the volume's maximum
    and the adjoint identity within 1e-4."""
    if case == "edges":
        joseph, jg, views, vol, g = _joseph_edge_case(cuda)
        first, last = joseph.step_range_reference(views.cpu(), jg)
        assert bool((last < first).any()) and bool((last >= first).any())
    else:
        nu, nv = map(int, case.split("x"))
        joseph, jg, views, vol, g = _joseph_case(cuda, seed=nu, nu=nu, nv=nv)
    got = joseph.joseph_project(vol, views, jg)
    want = joseph.project_one_reference(vol, views, jg)
    splat = joseph.joseph_splat(g, views, jg)
    want_splat = joseph.splat_one_reference(g, views, jg)
    torch.cuda.synchronize()
    assert got.shape == (3, len(jg.pixel_v), len(jg.pixel_u))
    assert float(want.abs().max()) > 0
    assert torch.equal(got, want)
    assert float((splat - want_splat).abs().max()) <= 1e-5 * float(want_splat.abs().max())
    lhs = float((got.double() * g.double()).sum())
    rhs = float((vol.double() * splat.double()).sum())
    assert abs(lhs - rhs) <= 1e-4 * abs(lhs)


# the (y, z) tile a block of tv_spatial owns (kTY, kTZ in csrc/tv_spatial.cu)
TV_TILE_Y, TV_TILE_Z = 8, 32


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 10])
@pytest.mark.parametrize("shape", [
    (2, 2, 2), (2, 5, 3), (3, TV_TILE_Y + 1, TV_TILE_Z + 1), (5, 2, TV_TILE_Z + 1),
    (4, TV_TILE_Y + 1, 2), (37, 29, 13)])
@pytest.mark.parametrize("n_iter", [0, 1, 2, 10])
def test_tv_spatial_kernel_on_card(cuda, n_iter, shape, batch):
    """n_iter + 1 launches, every voxel equal to the plain version's: axes
    at their minimum of 2, one voxel past a block's tile in y and in z."""
    from cbctmc_tpu_torch.recon import rooster

    rng = np.random.default_rng(9)
    vols = torch.from_numpy(rng.normal(size=(batch, *shape)).astype(np.float32)).to(cuda)
    before = kernels.launch_counts["tv_spatial"]
    got = rooster.spatial_tv(vols, 0.3, n_iter)
    assert kernels.launch_counts["tv_spatial"] == before + n_iter + 1
    want = rooster.spatial_tv_reference(vols, 0.3, n_iter)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 32768, 2, 2), (1, 2, 1024, 349526)])
def test_tv_spatial_kernel_refuses_too_large(cuda, shape):
    """The grid holds B * nx <= 65535 and offsets within a phase 3 n < 2^31
    (the second shape: 2.9 GB)."""
    from cbctmc_tpu_torch.recon import rooster

    with pytest.raises(ValueError, match="takes"):
        rooster.spatial_tv(torch.empty(shape, device=cuda), 0.3, 1)


def _temporal_on_card(vols, n_iter, weight=0.2):
    """One ``temporal_tv`` launch against the plain version on the card."""
    from cbctmc_tpu_torch.recon import rooster

    before = kernels.launch_counts["tv_temporal"]
    got = rooster.temporal_tv(vols, weight, n_iter)
    assert kernels.launch_counts["tv_temporal"] == before + 1
    want = rooster.temporal_tv_reference(vols, weight, n_iter)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 2, 2), (3, 5, 7), (37, 29, 13), (70, 66, 50)])
@pytest.mark.parametrize("n_phases", [1, 7, 10, 16])
@pytest.mark.parametrize("n_iter", [0, 1, 10])
def test_tv_temporal_kernel_on_card(cuda, n_iter, n_phases, shape):
    """One launch, every voxel equal to the plain version's: n = 8 and 105
    voxels a phase (less than a block's 256), 13,949 (rows not 16-byte
    aligned: n not a multiple of 4) and 231,000 (many blocks of 256 voxels,
    the last one partial)."""
    rng = np.random.default_rng(n_phases)
    _temporal_on_card(torch.from_numpy(
        rng.normal(size=(n_phases, *shape)).astype(np.float32)).to(cuda), n_iter)


@pytest.mark.gpu
@pytest.mark.parametrize("n_iter", [1, 10])
def test_tv_temporal_kernel_unaligned_volume_on_card(cuda, n_iter):
    """A volume that starts 4 bytes past an aligned address (a view one
    float into its storage), n a multiple of 4."""
    rng = np.random.default_rng(3)
    flat = torch.from_numpy(rng.normal(size=10 * 70 * 66 * 50 + 1).astype(np.float32)).to(cuda)
    _temporal_on_card(flat[1:].view(10, 70, 66, 50), n_iter)


@pytest.mark.gpu
@pytest.mark.parametrize("n_iter", [1, 10])
def test_tv_temporal_kernel_subnormal_range_on_card(cuda, n_iter):
    """Volumes scaled into float32's subnormal range (x / lambda, q, g and p
    below 2^-124, where tau g rounds and a fused p + tau g would differ)."""
    rng = np.random.default_rng(4)
    vols = (rng.normal(size=(10, 70, 66, 50)) * 1e-40).astype(np.float32)
    _temporal_on_card(torch.from_numpy(vols).to(cuda), n_iter)


@pytest.mark.gpu
@pytest.mark.parametrize("n_iter", [0, 1, 10])
def test_tv_temporal_kernel_air_on_card(cuda, n_iter):
    """Voxels that skip the loop, one value in every phase: exact zeros (0
    or -0, whole blocks of them) and nonzero values; beside them, in the
    same warps, voxels that are 0 in some phases only and voxels that differ
    from one value in a single phase."""
    rng = np.random.default_rng(5)
    vols = rng.normal(size=(10, 70, 66, 50)).astype(np.float32)
    vols[:, rng.random((70, 66, 50)) < 0.5] = 0.0
    vols[:, :20] = 0.0
    vols[:, 30, :, :] = -0.0
    vols[rng.random((10, 70, 66, 50)) < 0.2] = 0.0
    vols[:, 40:50] = vols[0, 40:50]
    vols[3, 45:50][rng.random((5, 66, 50)) < 0.3] += 1.0
    _temporal_on_card(torch.from_numpy(vols).to(cuda), n_iter)


@pytest.mark.gpu
@pytest.mark.parametrize("weight, scale", [(1e-7, 1.0), (1e7, 1.0), (0.2, 1e30), (0.2, 1e-30)])
def test_tv_temporal_kernel_out_of_range_on_card(cuda, weight, scale):
    """Inputs outside the ranges where the kernel divides by its written-out
    sequence, which it must detect and divide truly instead: lambda below
    2^-20 and above 2^20, |v| above 2^90 (and v / lambda above 2^30), and
    nonzero |v| below 2^-90 (numerators below 2^-90 in the iteration)."""
    rng = np.random.default_rng(6)
    vols = (rng.normal(size=(10, 37, 29, 13)) * scale).astype(np.float32)
    for n_iter in (1, 10):
        _temporal_on_card(torch.from_numpy(vols).to(cuda), n_iter, weight)


@functools.lru_cache(maxsize=None)
def _division_check():
    """scripts/check_tv_temporal_division.py and its check kernel, built."""
    spec = importlib.util.spec_from_file_location(
        "check_tv_temporal_division",
        Path(__file__).resolve().parents[1] / "scripts" / "check_tv_temporal_division.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module, module.build()


@pytest.mark.gpu
@pytest.mark.parametrize("ea, eb, negative", [
    (-1, 0, False), (-1, 0, True), (-6, -13, False), (-90, 29, False), (89, -20, True),
    (29, 29, False)])
def test_tv_temporal_division_on_card(cuda, ea, eb, negative):
    """The kernel's divisions (csrc/tv_temporal.cu ``reciprocal`` and
    ``divide``, the compiler's correctly rounded sequence written out) give
    the nearest float to a / b and equal the card's ``__fdiv_rn``, counted in
    a kernel built from a copy of the source: every mantissa of b in [2^eb,
    2^(eb + 1)) against 4 mantissas of a in [2^ea, 2^(ea + 1)) each. The
    binade pairs lie inside the ranges where the kernel takes the sequence
    and at their corners; the check of every mantissa pair is the script's
    (run without arguments). The ranges themselves are held through
    ``temporal_tv`` by the out-of-range, subnormal and air tests."""
    module, fn = _division_check()
    got = module.count(fn, ea, eb, step=1 << 21, negative=negative)
    assert got["checked"] == 4 << 23
    assert (got["differ"], got["wrong"]) == (0, 0), got


@pytest.mark.gpu
def test_tv_temporal_kernel_refuses_too_many_phases(cuda):
    from cbctmc_tpu_torch.recon import rooster

    with pytest.raises(ValueError, match="phases"):
        rooster.temporal_tv(torch.zeros((17, 4, 4, 4), device=cuda), 0.2, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("method, projector", [
    ("cg", "shearwarp"), ("cg", "joseph"), ("landweber", "joseph")])
def test_rooster_on_card_matches_cpu(cuda, method, projector):
    """The whole reconstruction through the kernels against the plain
    versions on the CPU (tests/test_rooster.py's two-state phantom): the
    splat's atomics, cuBLAS and the card's reductions change summation
    orders, which CG amplifies: 1e-4 of the volumes' maximum."""
    from cbctmc_tpu_torch.recon import joseph, rooster
    from cbctmc_tpu_torch.recon.geometry import ConeBeamGeometry, VolumeGrid

    geom = ConeBeamGeometry(sad=400.0, sdd=600.0, n_pixels_u=64, n_pixels_v=4,
                            pixel_size_u=6.0, pixel_size_v=8.0, detector_offset_u=0.0)
    coords = (np.arange(48) - 23.5) * 4.0
    x, y = np.meshgrid(coords, coords, indexing="ij")
    angles = 270.0 + np.arange(24) * 15.0
    proj = np.empty((24, 4, 64), np.float32)
    for k, off in enumerate((16.0, -16.0)):
        vol = np.repeat(((((x - off) ** 2 + y**2) <= 40.0**2) * 0.02).astype(np.float32)[
            :, :, None], 4, 2)
        proj[k::2] = joseph.project_forward(vol, geom, angles[k::2], volume_spacing=(4.0,) * 3,
                                            step_mm=2.0, device="cpu")
    phase = np.where(np.arange(24) % 2 == 0, 0.0, 0.5)
    par = rooster.RoosterParameters(n_phases=2, n_iterations=3, n_data_subiterations=2,
                                    n_tv_iterations=5, gamma_space=1e-5, gamma_time=1e-4,
                                    data_method=method, projector=projector)
    grid = VolumeGrid(shape=(48, 48, 4), spacing=(4.0,) * 3)
    got = rooster.rooster_reconstruct(proj, geom, angles, phase, grid=grid, parameters=par,
                                      device=cuda)
    want = rooster.rooster_reconstruct(proj, geom, angles, phase, grid=grid, parameters=par,
                                       device="cpu")
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


# ---------------------------------------------------------------------------
# the demons registration's three kernels
# ---------------------------------------------------------------------------
# the coarsest level of the full-width pyramid, the minimum level size, and
# sizes that are not multiples of a block (256) in any grouping
DEMONS_SHAPES = [(8, 8, 8), (88, 65, 36), (37, 29, 13), (9, 8, 257)]


def _demons_inputs(shape, cuda, seed, masked=True, amplitude=2.0):
    from cbctmc_tpu_torch.registration import demons

    rng = np.random.default_rng(seed)
    fixed = rng.random(shape).astype(np.float32)
    moving = np.roll(fixed, 2, axis=0) + rng.normal(scale=0.05, size=shape).astype(np.float32)
    mask = (rng.random(shape) if masked else np.ones(shape)).astype(np.float32)
    dvf = rng.normal(size=(3, *shape)).astype(np.float32)
    dvf = demons.blur3d(torch.from_numpy(dvf), demons._gaussian_kernel1d(1.25)) * amplitude
    to = lambda a: torch.as_tensor(a).contiguous().to(cuda)  # noqa: E731
    return to(fixed), to(moving), to(mask), to(dvf)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", DEMONS_SHAPES)
@pytest.mark.parametrize("masked", [False, True])
def test_demons_force_kernel_on_card(cuda, shape, masked):
    """The force and the pull alone, one launch each, every value equal to
    the plain version's; the field reaches past every face (edge clamps)."""
    from cbctmc_tpu_torch.registration import demons

    fixed, moving, mask, dvf = _demons_inputs(shape, cuda, 1, masked, amplitude=8.0)
    grads = demons.level_gradients(fixed)
    before = kernels.launch_counts["demons_force"]
    got = demons.demons_force(moving, fixed, mask, dvf, grads, 2.0)
    warped = demons.warp_volume(moving, dvf)
    assert kernels.launch_counts["demons_force"] == before + 2
    want = demons.demons_force_reference(moving, fixed, mask, dvf, grads, 2.0)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(warped, demons.warp_volume_reference(moving, dvf))


# dims below 2r + 1, ragged against the 16 y x 32 z tile, and longer than
# one x chunk (the wrapper cuts x into chunks to fill the card)
BLUR_SHAPES = [(37, 29, 13), (8, 8, 8), (2, 5, 142), (88, 65, 36), (9, 300, 33)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", BLUR_SHAPES)
@pytest.mark.parametrize("radius", [1, 3, 4, 8])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("folded", [False, True])
def test_demons_blur_kernel_on_card(cuda, shape, radius, channels, folded):
    """The 3-D blur, one launch, every value equal to the plain version's
    (three passes of ``blur_axis_reference``), with and without the folded
    addend."""
    from cbctmc_tpu_torch.registration import demons

    rng = np.random.default_rng(channels + radius)
    full = (channels, *shape) if channels == 3 else shape
    x = torch.from_numpy(rng.normal(size=full).astype(np.float32)).to(cuda)
    add = torch.from_numpy(rng.normal(size=full).astype(np.float32)).to(cuda) if folded else None
    taps = demons._gaussian_kernel1d(radius / 3)
    assert len(taps) == 2 * radius + 1
    before = kernels.launch_counts["demons_blur"]
    got = demons.blur3d(x, taps, add)
    assert kernels.launch_counts["demons_blur"] == before + 1
    want = demons.blur3d_reference(x, taps, add)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", DEMONS_SHAPES + [(2, 2, 2), (2, 3, 5)])
def test_demons_jacobian_kernel_on_card(cuda, shape):
    """The fold check, one launch, equal to the plain version on a field
    large enough to fold in places (both branches taken), the one-sided
    differences of every face included."""
    from cbctmc_tpu_torch.registration import demons

    _, _, _, new = _demons_inputs(shape, cuda, 2, amplitude=6.0)
    old = torch.from_numpy(np.random.default_rng(3).normal(size=new.shape).astype(
        np.float32)).to(cuda)
    before = kernels.launch_counts["demons_jacobian"]
    got = demons.jacobian_select(new, old, 0.05)
    assert kernels.launch_counts["demons_jacobian"] == before + 1
    want = demons.jacobian_select_reference(new, old, 0.05)
    torch.cuda.synchronize()
    folded = demons.jacobian_determinant(new) < 0.05
    assert torch.equal(got, want)
    if min(shape) > 2:
        assert 0 < int(folded.sum()) < folded.numel()


@pytest.mark.gpu
@pytest.mark.parametrize("use_jacobian", [False, True])
def test_demons_level_on_card_matches_plain(cuda, use_jacobian):
    """Five iterations of a level through the kernels (4 launches each)
    equal the plain versions on the card to the bit."""
    from cbctmc_tpu_torch.registration import demons

    fixed, moving, mask, dvf = _demons_inputs((88, 65, 36), cuda, 4, amplitude=1.0)
    kf, kd = demons._gaussian_kernel1d(1.0), demons._gaussian_kernel1d(1.25)
    kernels.reset_launch_counts()
    got = demons._demons_level(fixed, moving, dvf, 5, 2.0, kf, kd, mask, 0.05, use_jacobian)
    assert kernels.launch_counts["demons_force"] == 5
    assert kernels.launch_counts["demons_blur"] == 10
    assert kernels.launch_counts["demons_jacobian"] == (5 if use_jacobian else 0)
    want = demons._demons_level(fixed, moving, dvf, 5, 2.0, kf, kd, mask, 0.05, use_jacobian,
                                plain=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_demons_wrappers_refuse_a_device_mix(cuda):
    from cbctmc_tpu_torch.registration import demons

    fixed, moving, mask, dvf = _demons_inputs((8, 8, 8), cuda, 5)
    grads = demons.level_gradients(fixed)
    with pytest.raises(ValueError, match="on cpu"):
        demons.demons_force(moving, fixed, mask.cpu(), dvf, grads, 2.0)
    with pytest.raises(ValueError, match="on cpu"):
        demons.warp_volume(moving, dvf.cpu())
    with pytest.raises(ValueError, match="on cpu"):
        demons.blur3d(dvf, demons._gaussian_kernel1d(1.0), dvf.cpu())
    with pytest.raises(ValueError, match="on cpu"):
        demons.jacobian_select(dvf, dvf.cpu(), 0.05)
    with pytest.raises(ValueError, match="on cuda"):
        demons.jacobian_select(dvf.cpu(), dvf, 0.05)


@pytest.mark.gpu
def test_register_on_card_matches_cpu(cuda):
    """A whole registration on the card (kernels, cuBLAS resizes) against
    the plain versions on the CPU: the resizes' products sum in other
    orders, which the iterations carry: 1e-4 of the field's largest value."""
    from cbctmc_tpu_torch.registration import demons

    shape = (32, 32, 32)
    coords = np.indices(shape).astype(np.float32)
    blob = lambda c: np.exp(-(((coords - np.array(c, np.float32)[:, None, None, None]) ** 2)  # noqa: E731
                              .sum(0) / 30.0)).astype(np.float32)
    params = demons.DemonsParameters(iterations=30, n_levels=2)
    got = demons.register(blob((19, 16, 16)), blob((16, 16, 16)), params, device=cuda)
    want = demons.register(blob((19, 16, 16)), blob((16, 16, 16)), params, device="cpu")
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


# ---------------------------------------------------------------------------
# the trainers: a step on the card against the same step on the CPU
# ---------------------------------------------------------------------------
def _train_step(trainer, state, batch, n, dtype=torch.float32):
    """Loss, global gradient norm, gradients and updated parameters (float64,
    on the CPU) of one step of ``trainer`` from ``state`` (on the CPU), and
    the CPU state after it."""
    from cbctmc_tpu_torch.models.training import AdamState, TrainState

    dev = trainer.device
    params = {k: v.to(dev, dtype) for k, v in state.params.items()}
    opt = AdamState(state.opt_state.count,
                    {k: v.to(dev, dtype) for k, v in state.opt_state.mu.items()},
                    {k: v.to(dev, dtype) for k, v in state.opt_state.nu.items()})
    loss, grads = trainer.gradients(
        params, {k: v.to(dtype) for k, v in trainer.to_device(batch).items()}, n)
    new, opt, g_norm = trainer.optimizer.update(grads, opt, params)
    out = {"loss": float(loss), "g_norm": float(g_norm),
           "grads": {k: v.double().cpu() for k, v in grads.items()},
           "params": {k: v.double().cpu() for k, v in new.items()}}
    cpu = {k: v.float().cpu() for k, v in new.items()}
    return out, TrainState(cpu, AdamState(opt.count, {k: v.float().cpu() for k, v in opt.mu.items()},
                                          {k: v.float().cpu() for k, v in opt.nu.items()}))


def _distance(got, ref, rate):
    g2 = sum(float(((got["grads"][k] - v) ** 2).sum()) for k, v in ref["grads"].items())
    r2 = sum(float((v ** 2).sum()) for v in ref["grads"].values())
    dp = torch.cat([(got["params"][k] - v).flatten() for k, v in ref["params"].items()])
    return {"loss": abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
            "g_norm": abs(got["g_norm"] - ref["g_norm"]) / ref["g_norm"],
            "grads": (g2 / r2) ** 0.5, "params": float(dp.pow(2).mean().sqrt()) / rate}


@pytest.mark.gpu
@pytest.mark.parametrize("net", ["speedup", "segmenter"])
def test_train_step_on_card_matches_cpu(cuda, net):
    """Full-width nets on small inputs, each step from the same state on the
    card and in float64 on the CPU: the speedup net one step on each side of
    the L1 -> NLL switch (inputs away from the losses' kinks), the segmenter
    one step. The card's distances from the float64 step, as
    ``chip_smoke.step_parity`` holds them: the loss within 1e-6 and the
    global gradient norm within 5e-3 (relative), the gradients within 5e-2
    as a relative L2 distance and the updated parameters within 0.3 of the
    rate as an RMS (a max-pool window whose two largest values swap moves a
    gradient to another weight, ~1e-3 of the gradients on either device);
    cuDNN's TF32 flag off as every convolution's backward starts, and the
    caller's flag restored."""
    from cbctmc_tpu_torch.models import training
    from cbctmc_tpu_torch.models.datasets import SegmentationPatchDataset
    from cbctmc_tpu_torch.models.segmentation import default_segmenter_model
    from cbctmc_tpu_torch.models.speedup_net import MCSpeedUpNet
    from cbctmc_tpu_torch.models.synthetic_ct import generate_case

    rng = np.random.default_rng(5)
    if net == "speedup":
        batches = []
        for _ in range(2):
            low = (2.5 + rng.gamma(4.0, 0.25, (2, 64, 64))).astype(np.float32)
            fp = (low + rng.normal(0.0, 0.05, low.shape)).astype(np.float32)
            high = (3.0 * low + 1.0 + rng.normal(0.0, 0.02, low.shape)).astype(np.float32)
            batches.append({"input": np.stack([low, fp], -1), "target": high[..., None]})
        make = lambda dev: training.SpeedupTrainer(MCSpeedUpNet(), n_pretrain_steps=1,
                                                   learning_rate=2e-4, device=dev)
    else:
        image, labels = generate_case(1000, shape=(64, 48, 32))
        batches = [next(iter(SegmentationPatchDataset(images=[image], labels=[labels],
                                                      patch_shape=(32, 32, 32), seed=3)))]
        make = lambda dev: training.SegmentationTrainer(default_segmenter_model(),
                                                        learning_rate=2e-4, device=dev)
    previous = torch.backends.cudnn.allow_tf32
    cpu, card, wide = make("cpu"), make(cuda), make("cpu")
    state = cpu.init(torch.Generator().manual_seed(0), batches[0])
    tols = {"loss": 1e-6, "g_norm": 5e-3, "grads": 5e-2, "params": 0.3}
    flags = []
    for m in card.model.modules():
        if isinstance(m, torch.nn.modules.conv._ConvNd):
            m.register_full_backward_pre_hook(
                lambda *_: flags.append(torch.backends.cudnn.allow_tf32))
    for n, batch in enumerate(batches):
        ref, _ = _train_step(wide, state, batch, n, torch.float64)
        flags.clear()
        got, _ = _train_step(card, state, batch, n)
        assert flags and not any(flags)
        assert torch.backends.cudnn.allow_tf32 == previous
        d_card = _distance(got, ref, float(cpu.optimizer.schedule(n)))
        for key, tol in tols.items():
            assert d_card[key] <= tol, (n, key, d_card)
        state = _train_step(cpu, state, batch, n)[1]
