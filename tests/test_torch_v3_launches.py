"""The v3 body's launch bookkeeping and argument checks, on the CPU: which
launches a v3 sub-phase hands to the card and how each is counted (the
launch functions are recorded in place of the kernels, which the CPU cannot
run), the scan scratch each launch takes, and what the wrappers refuse
before any launch. The kernels themselves are held against their plain
versions on the card (tests/test_torch_gpu.py)."""

import importlib.util
import types
from pathlib import Path

import pytest
import torch

from cbctmc_tpu_torch.engine import kernels, transport

V3 = transport.production_engine_config(n_lanes=1000, resolve_inplace=False)


@pytest.fixture
def recorded(monkeypatch):
    """The launches handed to ``kernels._call``: (name, args) in order."""
    calls = []
    monkeypatch.setattr(kernels, "_call", lambda name, *args: calls.append((name, args)))
    kernels.reset_launch_counts()
    yield calls
    kernels.reset_launch_counts()


def _fake_engine(monkeypatch, config=V3):
    """Engine constants and state stand-ins whose launch arguments are built
    on the CPU (``kernels._phase_args`` refuses a CPU state)."""
    n, c_e = config.n_lanes, config.event_lanes
    args = types.SimpleNamespace(
        compact=kernels.CompactBuffers.allocate(n, c_e, "cpu"), n=n, lanes=kernels._LanesC(),
        options=kernels._OptionsC(), params_ptr=0, phase_ptr=0)
    monkeypatch.setattr(kernels, "_phase_args", lambda C, st: args)
    lanes = types.SimpleNamespace(pending=torch.zeros(n, dtype=torch.bool),
                                  alive=torch.ones(n, dtype=torch.bool))
    st = types.SimpleNamespace(lanes=lanes, ctrl=torch.zeros(20, dtype=torch.int32),
                               image=torch.zeros(9), counters=torch.zeros(10, dtype=torch.int64),
                               energy=torch.zeros(1, dtype=torch.float64),
                               block_dead=torch.zeros(4, dtype=torch.int32), events_idx=None)
    C = types.SimpleNamespace(
        config=config, n_lanes=n, rows=types.SimpleNamespace(resolve=(40, 110), v3_offsets=(0, 2, 26, 62)),
        event_pair=torch.zeros(6 * 8), icdf=torch.zeros(4), shells=torch.zeros(3, 2, 4),
        rita=torch.zeros(4, 256))
    monkeypatch.setattr(kernels, "_stream", lambda t: 0)
    return C, st, args


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_tests", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_scan_scratch_sizes():
    """The scratch of the two scanning launches, int64 and all zero: the
    tally's one ticket and two rows of flags (the doubles', the events'), a
    flag a block at its widest grid (256 lanes a block); the resolve's
    ticket and a flag a block of its grid at its widest tile. The events'
    slots are the engine state's."""
    B = kernels.CompactBuffers.allocate(3000, 350, "cpu")
    assert kernels.scan_words(4) == 5 and kernels.tally_scan_words(3000) == 25
    for scan, words in ((B.tally_scan, 25),
                        (B.rayleigh_scan, 1 + -(-350 * kernels.RESOLVE_TILE_MAX // 256))):
        assert scan.dtype == torch.int64 and scan.shape == (words,)
        assert not scan.any()
    assert set(B._fields) == {"tally_scan", "rayleigh_scan"}


@pytest.mark.parametrize("with_ctrl", [False, True])
def test_compact_is_one_launch(recorded, with_ctrl):
    """``compact`` is one launch: counted by the wrapper outside the engine,
    as enqueued (the device counts it) inside it."""
    m = 3000
    a, b = torch.ones(m, dtype=torch.uint8), torch.zeros(m, dtype=torch.uint8)
    scan = torch.zeros(kernels.scan_words(3), dtype=torch.int64)  # 3 blocks of 1,024
    idx = torch.empty(300, dtype=torch.int32)
    ctrl = torch.zeros(20, dtype=torch.int32) if with_ctrl else None
    kernels.launch_compact(a, b, scan, 300, m, idx, None, ctrl, 0)
    assert [name for name, _ in recorded] == ["compact"]
    args = recorded[0][1]
    assert args[2] == m and args[3] == scan.data_ptr() and args[4:7] == (4, 300, m)
    assert args[8] is None and (args[9] is None) == (not with_ctrl)
    assert kernels.launch_counts["compact"] == (0 if with_ctrl else 1)
    assert kernels.enqueued_counts["compact"] == (1 if with_ctrl else 0)


def test_compact_refuses_before_launching(recorded):
    m = 3000
    a = torch.ones(m, dtype=torch.uint8)
    idx = torch.empty(10, dtype=torch.int32)
    with pytest.raises(ValueError, match="expected 4"):
        kernels.launch_compact(a, None, torch.zeros(13, dtype=torch.int64), 10, m, idx, None,
                               None, 0)
    with pytest.raises(TypeError, match="int64"):
        kernels.launch_compact(a, None, torch.zeros(4, dtype=torch.int32), 10, m, idx, None,
                               None, 0)
    with pytest.raises(ValueError, match="budget"):
        kernels.launch_compact(a, None, torch.zeros(4, dtype=torch.int64), -1, m, idx, None,
                               None, 0)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.compact(torch.ones(m, dtype=torch.bool), 10, m)
    with pytest.raises(ValueError, match="1-D"):
        kernels.compact(torch.ones((2, 3), dtype=torch.bool), 10, 6)
    with pytest.raises(TypeError, match="bool"):
        kernels.compact(torch.ones(m, dtype=torch.uint8), 10, m)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.control_floor(torch.zeros(20, dtype=torch.int32), 4)
    assert recorded == [] and kernels.launch_counts["compact"] == 0


def test_v3_subphase_launches(recorded, monkeypatch):
    """A v3 sub-phase hands the card two launches (the fused tally, which
    also ranks the events, and the fused resolve; no ``compact``) and the
    last one of an iteration the finish as well: with the refill and the two
    flights 8 an iteration at two sub-phases, which is what
    chip_smoke.expected_phase_launches holds the device's launch words to."""
    C, st, args = _fake_engine(monkeypatch)
    R = V3.n_resolves
    for r in range(R):
        kernels.launch_tally_compacted(C, st)
        kernels.launch_resolve_compacted(C, st, r, ends_iteration=r == R - 1)
    names = [name for name, _ in recorded]
    sub = ["tally_compacted", "resolve_compacted"]
    assert names == sub * R + ["resolve_compacted:resolve_finish"]
    per_kernel = {k: sum(n.partition(":")[0] == k for n in names)
                  for k in ("compact", "tally_compacted", "resolve_compacted")}
    assert per_kernel == {k: kernels.enqueued_counts[k] for k in per_kernel}
    assert per_kernel["compact"] == 0
    want = _smoke().expected_phase_launches(1, V3)
    assert {k: want[k] for k in per_kernel} == per_kernel
    assert want["refill"] + want["flight_resolve"] + sum(per_kernel.values()) == 8
    assert sum(_smoke().expected_phase_launches(1, transport.production_engine_config())
               .values()) == 4
    # the tally takes its scan scratch, the doubles' budget and the events'
    # slots of the state; the resolve those slots, its own scan scratch and
    # the rows of its sub-phase
    B = args.compact
    tally = recorded[0][1]
    assert st.events_idx.shape == (V3.event_lanes,) and st.events_idx.dtype == torch.int32
    assert tally[6:11] == (B.tally_scan.data_ptr(), B.tally_scan.shape[0], V3.doubles_lanes,
                           st.events_idx.data_ptr(), V3.event_lanes)
    res = recorded[1][1]
    assert res[1] == st.events_idx.data_ptr() and res[2] == V3.event_lanes
    assert res[10:13] == (B.rayleigh_scan.data_ptr(), B.rayleigh_scan.shape[0],
                          V3.rayleigh_lanes)
    assert res[16:20] == tuple(C.rows.resolve[0] + k for k in C.rows.v3_offsets)
    assert res[21:23] == (int(V3.tau_table), int(V3.tally_dose))


def test_v3_resolve_refuses_a_scratch_of_another_grid(recorded, monkeypatch):
    C, st, args = _fake_engine(monkeypatch)
    B = args.compact
    args.compact = B._replace(rayleigh_scan=B.rayleigh_scan[:-1].clone())
    with pytest.raises(ValueError, match="rayleigh scan"):
        kernels.launch_resolve_compacted(C, st, 0)
    args.compact = B._replace(tally_scan=torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="tally scan"):
        kernels.launch_tally_compacted(C, st)
    args.compact = B
    st.events_idx = torch.zeros(V3.event_lanes - 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="events_idx"):
        kernels.launch_tally_compacted(C, st)
    assert recorded == []


def test_v3_entries_are_the_launch_functions():
    """The launch functions an iteration calls (loaded before a graph is
    recorded): the production ones, and under v3 the two kernels' three."""
    assert kernels.phase_entries(transport.production_engine_config()) == (
        "refill", "flight_resolve")
    assert kernels.phase_entries(V3) == (
        "refill", "flight_resolve", "tally_compacted", "resolve_compacted",
        "resolve_compacted:resolve_finish")
    for entry in kernels.phase_entries(V3):
        assert entry in kernels._SIGNATURES


def test_block_sizes_are_the_sources():
    """The wrapper's resolve tile (the floor's grid in chip_smoke.py),
    compact's entries a block (its scan scratch) and the tally's lanes a
    block are the ones the kernels are built with; the tile within what the
    resolve's scratch holds, the tally's block no narrower than the grid its
    scratch holds."""
    text = (Path(kernels.CSRC) / "resolve_compacted.cu").read_text()
    assert f"#define RESOLVE_TILE {kernels.RESOLVE_TILE}\n" in text
    assert kernels.RESOLVE_TILE <= kernels.RESOLVE_TILE_MAX
    text = (Path(kernels.CSRC) / "compact.cu").read_text()
    items = kernels.COMPACT_BLOCK // kernels.PHASE_BLOCK
    assert f"#define COMPACT_ITEMS {items}\n" in text
    assert "#define COMPACT_BLOCK (PHASE_THREADS * COMPACT_ITEMS)" in text
    text = (Path(kernels.CSRC) / "tally_compacted.cu").read_text()
    assert f"#define TALLY_ITEMS {kernels.TALLY_BLOCK // kernels.PHASE_BLOCK}\n" in text
    assert "#define TALLY_BLOCK (PHASE_THREADS * TALLY_ITEMS)" in text
    assert kernels.TALLY_BLOCK % kernels.PHASE_BLOCK == 0
