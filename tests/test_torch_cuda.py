"""The port on the card: the CUDA level-loop kernel against its plain
version, and the device search through it.  Every test needs an NVIDIA
GPU and skips without one.  The file imports neither jax nor the JAX
package, so it runs where they are absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import random

import pytest
import torch

from jepsen_tpu_torch.checker import encode as enc
from jepsen_tpu_torch.checker import level_kernel as lk
from jepsen_tpu_torch.checker import linearizable as lin
from jepsen_tpu_torch.checker import step
from jepsen_tpu_torch.checker.linearizable import search_opseq
from jepsen_tpu_torch.history import encode_ops, invoke_op, ok_op
from jepsen_tpu_torch.models import cas_register, mutex
from jepsen_tpu_torch.synth import (corrupt_read, register_history,
                                    sim_mutex_history)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _lockstep(model, seq, frontier, bail, device, *, slices=8, lvl_cap=8):
    """Kernel and plain version from the root, slice by slice: the live
    rows and the five scalars must be identical."""
    es = enc.encode_search(seq)
    dims = enc.choose_dims(es, model, device=device, frontier=frontier)
    esp = enc.pad_search(es, dims.n_det_pad, dims.n_crash_pad)
    args = enc.search_args(esp, es, device=device)
    ck = cr = enc.carry_to_device(enc._init_carry(dims, model), device)
    for _ in range(slices):
        before = lk.LAUNCHES
        ck = lk.level_loop(model, dims, *args, 10**8, lvl_cap, bail, *ck)
        assert lk.LAUNCHES == before + 1
        cr = lk.level_loop_reference(model, dims, *args, 10**8, lvl_cap,
                                     bail, *cr)
        torch.cuda.synchronize()
        n = int(cr[1])
        assert [int(v) for v in ck[1:]] == [int(v) for v in cr[1:]]
        assert torch.equal(ck[0][:n], cr[0][:n])
        if int(cr[2]) != -1 or n == 0 or (bail and bool(cr[5])):
            break
    return dims


@pytest.mark.cuda
@pytest.mark.parametrize("frontier", [16, 128, 512])
@pytest.mark.parametrize("seed,bail", [(1, False), (2, False), (21, True)])
def test_kernel_matches_reference(cuda, seed, bail, frontier):
    model = cas_register()
    rng = random.Random(seed)
    wide = frontier > 16
    h = register_history(rng, n_ops=200 if wide else 64,
                         n_procs=12 if wide else (8 if bail else 4),
                         overlap=10 if wide else (7 if bail else 3),
                         crash_p=0.06, max_crashes=6 if wide else 3,
                         n_values=2 if bail else 3)
    if seed % 2:
        h = corrupt_read(rng, h, at=0.85)
    _lockstep(model, encode_ops(h, model.f_codes), frontier, bail, cuda)


@pytest.mark.cuda
def test_kernel_reads_device_tables_when_they_do_not_fit(cuda):
    """A history whose tables (n_det_pad 16384) exceed shared memory: the
    kernel takes its device-memory table path, still bit-identical."""
    model = mutex()
    h = sim_mutex_history(random.Random(7), n_ops=9000, n_procs=6,
                          crash_p=0.001, max_crashes=3)
    seq = encode_ops(h, model.f_codes)
    dims = _lockstep(model, seq, 64, False, cuda, slices=3)
    assert dims.n_det_pad == 16384
    assert lk.launch_plan(dims, cuda)["tables"] == "device"


@pytest.mark.cuda
def test_search_runs_the_kernel_and_matches_the_host(cuda, monkeypatch):
    model = mutex()
    h = sim_mutex_history(random.Random(5), n_ops=300, n_procs=4,
                          crash_p=0.02, max_crashes=4)
    # an acquire chain longer than the crashed ops can explain
    for p in range(100, 106):
        h += [invoke_op(p, "acquire"), ok_op(p, "acquire")]
    seq = encode_ops(h, model.f_codes)
    # with the prepass on, the chain decides the history with no search
    off = {"hb": False, "dpor": False}
    before = lk.LAUNCHES
    on_card = search_opseq(seq, model, device="cuda", **off)
    assert lk.LAUNCHES > before
    assert on_card["engine"] == "device-bfs(cuda)"
    # the card prunes all-pairs; pin the host to the same prune
    monkeypatch.setattr(step, "_DOMINANCE_MODE", "allpairs")
    on_host = search_opseq(seq, model, device="cpu", **off)
    for k in ("valid", "configs", "max_depth", "window"):
        assert on_card[k] == on_host[k], k
    assert on_card["valid"] is False


@pytest.mark.cuda
def test_1k_tier_search_runs_only_the_kernel(cuda, monkeypatch):
    """The 1k bench tier at its real size, with the defaults: the kernel
    takes the starting rung, so the search drops its reductions, and
    every slice, on every rung the ladder takes, runs the CUDA level
    loop with the unreduced counts."""
    from chip_smoke import REFERENCE, tier_history

    routes = []
    use_kernel = lin._use_kernel

    def traced(model, dims, device, **reduction):
        routes.append((dims.frontier,
                       use_kernel(model, dims, device, **reduction)))
        return routes[-1][1]

    monkeypatch.setattr(lin, "_use_kernel", traced)
    seq, model = tier_history("1k")
    out = search_opseq(seq, model, device="cuda")
    assert routes and all(k for _f, k in routes), routes
    assert (out["valid"], out["configs"], out["max_depth"]) == \
        REFERENCE["1k"]
    assert out["dpor"]["device_masked"] is False


@pytest.mark.cuda
def test_masked_step_on_the_card_matches_the_host(cuda, monkeypatch):
    """With the kernel kept out, the card runs the masked, deduplicated
    torch step, and it gives the host's counts under the same prune."""
    model = cas_register()
    rng = random.Random(31)
    h = corrupt_read(rng, register_history(
        rng, n_ops=200, n_procs=12, overlap=10, crash_p=0.06,
        max_crashes=6, n_values=3), at=0.85)
    seq = encode_ops(h, model.f_codes)
    monkeypatch.setattr(lin, "_use_kernel", lambda *a, **kw: False)
    before = lk.LAUNCHES
    on_card = search_opseq(seq, model, device="cuda")
    assert lk.LAUNCHES == before and on_card["dpor"]["device_masked"]
    monkeypatch.setattr(step, "_DOMINANCE_MODE", "allpairs")
    on_host = search_opseq(seq, model, device="cpu")
    for k in ("valid", "configs", "max_depth", "dpor"):
        assert on_card[k] == on_host[k], k


def _grid_steps(model, dims, args, carry, bail, slices=3, lvl_cap=16):
    """The grid form and its plain version from ``carry``: every key's
    scalars and live rows identical after every slice."""
    from chip_smoke import grid_diff

    ck = cr = carry
    for _ in range(slices):
        before = lk.BATCH_LAUNCHES
        ck = lk.level_loop_batch(model, dims, *args, 10**8, lvl_cap, bail,
                                 *ck)
        assert lk.BATCH_LAUNCHES == before + 1
        cr = lk.level_loop_batch_reference(model, dims, *args, 10**8,
                                           lvl_cap, bail, *cr)
        torch.cuda.synchronize()
        assert grid_diff(ck, cr) == 0
    return ck


@pytest.mark.cuda
@pytest.mark.parametrize("n_keys,lanes,frontier,bail",
                         [(1, 1, 32, True), (5, 8, 128, False),
                          (64, 64, 32, True)])
def test_grid_matches_reference(cuda, n_keys, lanes, frontier, bail):
    """B=1, 5 (with 3 pad lanes) and 64 keys of the batch256 tier."""
    from chip_smoke import batch_keys, grid_setup

    keys, model = batch_keys(n_keys)
    dims, args, carry = grid_setup(model, keys, frontier, cuda, lanes=lanes)
    out = _grid_steps(model, dims, args, carry, bail)
    # pad lanes come back as they went in
    assert out[2][n_keys:].eq(lin.VALID).all()
    assert out[1][n_keys:].eq(0).all()


@pytest.mark.cuda
def test_grid_equals_single_launches(cuda):
    """Each key of a grid launch gets what its own single-key launch
    gives, from rows that start at the stride the stacking rounds to
    16 bytes (``n_det_pad + 1`` is never a multiple of 4)."""
    from chip_smoke import batch_keys, grid_diff, grid_setup

    keys, model = batch_keys(6)
    dims, args, carry = grid_setup(model, keys, 32, cuda)
    assert args[5].shape[1] == lk.sfx_stride(dims) != dims.n_det_pad + 1
    grid = lk.level_loop_batch(model, dims, *args, 10**8, 32, True, *carry)
    for b in range(len(keys)):
        key_args = [t[b] for t in args[:15]]
        key_args[5] = key_args[5][:dims.n_det_pad + 1]
        assert key_args[5].data_ptr() % 16 == 0
        one = lk.level_loop(model, dims, *key_args, int(args[15][b]),
                            int(args[16][b]), int(args[17][b]),
                            int(args[18][b]), 10**8, 32, True,
                            *(c[b] for c in carry))
        assert grid_diff(tuple(c[b:b + 1] for c in grid),
                         tuple(c.reshape((1,) + c.shape) for c in one)) == 0


@pytest.mark.cuda
def test_grid_refuses_unaligned_suffix_rows(cuda):
    """A suffix table stacked at its bare ``n_det_pad + 1`` stride would
    put key 1's row off a 16-byte boundary: the wrapper refuses it."""
    from chip_smoke import batch_keys, grid_setup

    keys, model = batch_keys(4)
    dims, args, carry = grid_setup(model, keys, 32, cuda)
    bad = list(args)
    bad[5] = args[5][:, :dims.n_det_pad + 1].contiguous()
    with pytest.raises(ValueError, match="table 5"):
        lk.level_loop_batch(model, dims, *bad, 10**8, 8, True, *carry)


def _tele_steps(launch, plain, diff, args, carry, bail, slices, lvl_cap):
    """Telemetry form, off form and the plain telemetry build from
    ``carry``, slice by slice: the two forms' carries identical, equal
    to the plain version's, and the blocks equal.  Returns the blocks'
    sum."""
    ck = ct = cr = carry
    total = None
    for _ in range(slices):
        ck = launch(*args, 10**8, lvl_cap, bail, *ck)
        on = launch(*args, 10**8, lvl_cap, bail, *ct, telemetry=True)
        ref = plain(*args, 10**8, lvl_cap, bail, *cr, telemetry=True)
        torch.cuda.synchronize()
        assert diff(on[:6], ck) == 0 and diff(ck, ref[:6]) == 0
        assert torch.equal(on[6].cpu(), ref[6].cpu())
        total = on[6] if total is None else total + on[6]
        ct, cr = on[:6], ref[:6]
    return total


@pytest.mark.cuda
@pytest.mark.parametrize("seed,bail", [(2, False), (21, True)])
def test_telemetry_form_matches_reference(cuda, seed, bail):
    """B1-T at B=1 against the all-pairs torch step's telemetry build,
    with crash-closure rounds and with an overflow under bail; and over
    a 300-level slice of mutex2k, whose last row folds the levels past
    the buffer."""
    from chip_smoke import _diff, tier_history

    model = cas_register()
    rng = random.Random(seed)
    h = register_history(rng, n_ops=64, n_procs=8 if bail else 4,
                         overlap=7 if bail else 3, crash_p=0.06,
                         max_crashes=3, n_values=2 if bail else 3)
    seq = encode_ops(h, model.f_codes)
    es = enc.encode_search(seq)
    dims = enc.choose_dims(es, model, device=cuda, frontier=16)
    esp = enc.pad_search(es, dims.n_det_pad, dims.n_crash_pad)
    args = enc.search_args(esp, es, device=cuda)
    carry = enc.carry_to_device(enc._init_carry(dims, model), cuda)
    before = dict(lk.LAUNCHES_BY_FORM)
    total = _tele_steps(lambda *a, **k: lk.level_loop(model, dims, *a, **k),
                        lambda *a, **k: lk.level_loop_reference(
                            model, dims, *a, **k),
                        _diff, args, carry, bail, 4, 16)
    assert lk.LAUNCHES_BY_FORM["single", True] == \
        before["single", True] + 4
    assert int(total[:, 4 if not bail else 6].sum()) > 0
    seq, model = tier_history("mutex2k")
    es = enc.encode_search(seq)
    dims = enc.choose_dims(es, model, device=cuda, frontier=64)
    esp = enc.pad_search(es, dims.n_det_pad, dims.n_crash_pad)
    args = enc.search_args(esp, es, device=cuda)
    carry = enc.carry_to_device(enc._init_carry(dims, model), cuda)
    total = _tele_steps(lambda *a, **k: lk.level_loop(model, dims, *a, **k),
                        lambda *a, **k: lk.level_loop_reference(
                            model, dims, *a, **k),
                        _diff, args, carry, False, 1, 300)
    assert int(total[127, 0]) > int(total[126, 0]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_keys,lanes,frontier,bail",
                         [(1, 1, 32, True), (5, 8, 128, False),
                          (37, 64, 32, True), (2, 2, 32, False),
                          (1, 8, 32, True)])
def test_grid_telemetry_form_matches_reference(cuda, n_keys, lanes,
                                               frontier, bail):
    """The grid form's telemetry build against the plain version, key by
    key, with pad lanes whose blocks read zero: B=2, and a lone running
    key among seven pad lanes; each launch counted at its rung."""
    from chip_smoke import batch_keys, grid_diff, grid_setup

    keys, model = batch_keys(n_keys)
    dims, args, carry = grid_setup(model, keys, frontier, cuda, lanes=lanes)
    before = lk.GRID_LAUNCHES[frontier, True]
    total = _tele_steps(
        lambda *a, **k: lk.level_loop_batch(model, dims, *a, **k),
        lambda *a, **k: lk.level_loop_batch_reference(model, dims, *a, **k),
        grid_diff, args, carry, bail, 3, 16)
    assert lk.GRID_LAUNCHES[frontier, True] == before + 3
    assert total.shape == (lanes, 128, 8)
    assert int(total[n_keys:].abs().sum()) == 0
    assert int(total[:n_keys, :, 0].sum()) > 0


@pytest.mark.cuda
def test_search_carries_the_reference_block_on_the_card(cuda, monkeypatch):
    """A device search on the card with telemetry at its default: the
    block rides the result, and with the slicing pinned it equals the
    block of the same search on the card's torch step (the kernel kept
    out); off, the result is the same without it."""
    model = mutex()
    h = sim_mutex_history(random.Random(5), n_ops=300, n_procs=4,
                          crash_p=0.02, max_crashes=4)
    # an acquire chain longer than the crashed ops can explain
    for p in range(100, 106):
        h += [invoke_op(p, "acquire"), ok_op(p, "acquire")]
    seq = encode_ops(h, model.f_codes)
    off = {"hb": False, "dpor": False}
    on_card = search_opseq(seq, model, device="cuda", **off)
    bare = search_opseq(seq, model, device="cuda", telemetry=False, **off)
    assert "search_telemetry" not in bare
    assert {k: v for k, v in on_card.items() if k != "search_telemetry"} \
        == bare
    monkeypatch.setattr(lin, "_SLICE_TARGET_S", 1e9)
    pinned = search_opseq(seq, model, device="cuda", **off)
    assert "cuda" in pinned["engine"]
    monkeypatch.setattr(lin, "_use_kernel", lambda *a, **kw: False)
    stepped = search_opseq(seq, model, device="cuda", **off)
    assert stepped["engine"] == "device-bfs"
    assert pinned["search_telemetry"] == stepped["search_telemetry"]


def _decompose_keys(n=4, copies=3):
    """``n`` overlapping cas-register shapes, ``copies`` of each, shape 0
    corrupted."""
    model = cas_register()
    seqs = []
    for k in range(n * copies):
        rng = random.Random(f"shape-{k % n}")
        h = register_history(rng, n_ops=64, n_procs=6, overlap=4,
                             crash_p=0.02, max_crashes=2, n_values=4)
        if k % n == 0:
            h = corrupt_read(rng, h, at=0.85)
        seqs.append(encode_ops(h, model.f_codes))
    return seqs, model


@pytest.mark.cuda
def test_decomposed_batch_on_the_card(cuda, tmp_path):
    """``search_batch(decompose=True)`` on the card against the CPU (DPOR
    off, so both run the unreduced search): the same verdicts, configs
    and ``decompose_batch`` stats, the grid form launched, and a second
    run on the same cache file all hits with no launch."""
    from jepsen_tpu_torch.decompose import VerdictCache

    seqs, model = _decompose_keys()
    path = str(tmp_path / "v.jsonl")
    before = lk.BATCH_LAUNCHES
    card = lin.search_batch(seqs, model, device="cuda", dpor=False,
                            decompose=True,
                            decompose_cache=VerdictCache(path))
    assert lk.BATCH_LAUNCHES > before
    cpu = lin.search_batch(seqs, model, device="cpu", dpor=False,
                           decompose=True)
    assert [r["valid"] for r in card] == [r["valid"] for r in cpu]
    assert [r["configs"] for r in card] == [r["configs"] for r in cpu]
    assert card[0]["decompose_batch"] == cpu[0]["decompose_batch"]
    assert card[0]["decompose_batch"]["deduped"] == 8
    before = lk.BATCH_LAUNCHES + lk.LAUNCHES
    warm = lin.search_batch(seqs, model, device="cuda", decompose=True,
                            decompose_cache=path)
    assert lk.BATCH_LAUNCHES + lk.LAUNCHES == before
    assert warm[0]["decompose_batch"]["cache_hits"] == len(seqs)
    assert [r["valid"] for r in warm] == [r["valid"] for r in card]


@pytest.mark.cuda
def test_device_scheduler_on_the_card(cuda):
    """``check_opseq_decomposed(scheduler="device")`` on the card against
    the CPU: the same verdict, cells and methods, the cells' engines
    tagged "(cuda)" where the grid form ran."""
    from jepsen_tpu_torch.decompose import check_opseq_decomposed
    from jepsen_tpu_torch.models import multi_register

    model = multi_register(8)
    history = []
    for k in range(8):
        rng = random.Random(f"bench-batch-{k}")
        h = register_history(rng, n_ops=128, n_procs=8, overlap=4,
                             crash_p=0.01, max_crashes=2, n_values=4,
                             cas=False)
        if k % 4 == 0:
            h = corrupt_read(rng, h, at=0.85)
        history += [type(op)(8 * k + op.process, op.type, op.f,
                             (k, op.value)) for op in h]
    seq = encode_ops(history, model.f_codes)
    before = lk.BATCH_LAUNCHES
    card = check_opseq_decomposed(seq, model, scheduler="device",
                                  device="cuda")
    assert lk.BATCH_LAUNCHES > before
    cpu = check_opseq_decomposed(seq, model, scheduler="device",
                                 device="cpu")
    assert card["valid"] == cpu["valid"] is False
    for k in ("cells", "segments", "methods"):
        assert card["decompose"][k] == cpu["decompose"][k]
    assert {e.replace("(cuda)", "") for e in
            card["decompose"]["cell_engines"]} == \
        set(cpu["decompose"]["cell_engines"])
    assert "device-batch(cuda)" in card["decompose"]["cell_engines"]


@pytest.mark.cuda
def test_stream_device_fold_on_the_card(cuda):
    """The stream's device fold at the JAX package test's size, on the
    card and on the CPU: the same state set per segment, the grid form
    launched; and a stream with every fold forced to the device gives
    the CPU run's verdict and routes."""
    from jepsen_tpu_torch.decompose.partition import (quiescence_segments,
                                                      subseq)
    from jepsen_tpu_torch.models import register
    from jepsen_tpu_torch.stream import StreamChecker
    from jepsen_tpu_torch.stream.device import device_fold_states

    model = register(0)
    h = register_history(random.Random(5), n_ops=48, n_procs=6, overlap=5,
                         quiesce_every=8, unique_writes=True, cas=False)
    seq = encode_ops(h, model.f_codes)
    states = {tuple(model.init)}
    before = lk.BATCH_LAUNCHES
    folded = 0
    for rows in quiescence_segments(seq)[:-1]:
        ss = subseq(seq, rows)
        card = device_fold_states(ss, model, states, device="cuda")
        cpu = device_fold_states(ss, model, states, device="cpu")
        assert (card is None) == (cpu is None)
        if card is not None:
            assert card[0] == cpu[0]
            states = card[0]
            folded += 1
        else:
            from jepsen_tpu_torch.decompose.engine import segment_states

            states = segment_states(ss, model, states)
    assert folded >= 2 and lk.BATCH_LAUNCHES > before

    h = register_history(random.Random(6), n_ops=40, n_procs=5, overlap=4,
                         quiesce_every=8, n_values=6, cas=False)
    out = {}
    for dev in ("cuda", "cpu"):
        sc = StreamChecker(model, device=dev, host_fold_max=0)
        for op in h:
            sc.ingest(op)
        out[dev] = sc.finalize()
    assert out["cuda"]["valid"] == out["cpu"]["valid"]
    assert out["cuda"]["stream"]["routes"] == out["cpu"]["stream"]["routes"]
    assert out["cuda"]["stream"]["routes"]["device"] >= 1


@pytest.mark.cuda
def test_sharded_routes_on_the_card(cuda, monkeypatch):
    """The sharded-frontier search over 4 logical shards of the card
    equals the same search over 4 CPU shards with the card's prune
    (all-pairs), whole result and telemetry, and gives the single-device
    search's verdict and depth; the key-sharded batch on the card gives
    the unsharded batch's verdicts, and its shards run the grid form."""
    from jepsen_tpu_torch.distributed import ShardMesh

    monkeypatch.setattr(lin, "_adapt_lvl_cap",
                        lambda cap, dt, target_s=None: cap)
    model = cas_register()
    rng = random.Random(42)
    h = register_history(rng, n_ops=220, n_procs=16, overlap=6,
                         crash_p=0.01, max_crashes=4)
    seq = encode_ops(corrupt_read(rng, h, at=0.95), model.f_codes)
    got = lin.search_opseq_sharded(seq, model, ShardMesh(["cuda:0"] * 4),
                                   frontier_per_device=64)
    monkeypatch.setattr(step, "_DOMINANCE_MODE", "allpairs")
    want = lin.search_opseq_sharded(seq, model, ShardMesh(["cpu"] * 4),
                                    frontier_per_device=64)
    monkeypatch.setattr(step, "_DOMINANCE_MODE", "auto")
    for f in ("valid", "configs", "max_depth", "engine",
              "frontier_per_device", "search_telemetry"):
        assert got[f] == want[f], f
    single = search_opseq(seq, model, device="cuda")
    assert (single["valid"], single["max_depth"]) == \
        (got["valid"], got["max_depth"])

    seqs = []
    for k in range(12):
        r = random.Random(900 + k)
        hk = register_history(r, n_ops=60, n_procs=5, overlap=4)
        if k % 3 == 0:
            hk = corrupt_read(r, hk, at=0.8)
        seqs.append(encode_ops(hk, model.f_codes))
    before = lk.BATCH_LAUNCHES
    sharded = lin.search_batch(seqs, model, sharding=ShardMesh(["cuda:0"] * 4),
                               hb=False, dpor=False)
    assert lk.BATCH_LAUNCHES > before
    plain = lin.search_batch(seqs, model, device="cuda", hb=False,
                             dpor=False)
    assert [r["valid"] for r in sharded] == [r["valid"] for r in plain]
    assert [r["max_depth"] for r in sharded] == \
        [r["max_depth"] for r in plain]



@pytest.mark.cuda
def test_fleet_warm_boot_and_routed_fold_on_the_card(cuda, tmp_path,
                                                     monkeypatch):
    """The fleet's warm boot on ``cuda:0`` launches B1 in both forms
    (a single-key shape, the traffic's batch shape) and verifies, and a
    second boot builds nothing; then a run routed through a two-worker
    in-process fleet (every segment folded on the card) finals as the
    single service does, with no kernel-cache miss."""
    from jepsen_tpu_torch.fleet import bench as fb
    from jepsen_tpu_torch.fleet.warmup import WarmShape, warm_boot

    monkeypatch.setattr(lin, "_STEP_CACHE", {})
    traffic = fb.record_traffic_shapes([fb._mk_history(2001, 80)],
                                       device="cuda", host_fold_max=0)
    assert traffic and not lin._STEP_CACHE
    shapes = [WarmShape(n_det_pad=64, frontier=64)] + traffic
    s0, g0 = lk.LAUNCHES, lk.BATCH_LAUNCHES
    rep = warm_boot(shapes, device="cuda:0")
    assert rep["verified"] is True and rep["compiled"] == len(shapes)
    assert lk.LAUNCHES > s0 and lk.BATCH_LAUNCHES > g0
    assert warm_boot(shapes, device="cuda:0")["compiled"] == 0

    fleet = fb.Fleet(str(tmp_path), device="cuda", host_fold_max=0)
    try:
        misses = lin.KERNEL_CACHE_STATS["misses"]
        g1 = lk.BATCH_LAUNCHES
        _ramp, finals, hists = fb.run_swarm(fleet.port, [2], 1, 80)
        assert lin.KERNEL_CACHE_STATS["misses"] == misses
        assert lk.BATCH_LAUNCHES > g1
    finally:
        fleet.close()
    par = fb.parity_check(finals, hists, device="cuda", host_fold_max=0,
                          sample=None)
    assert par["parity"] is True and par["checked"] == 2


@pytest.mark.cuda
def test_shard_tier_on_the_card(cuda, tmp_path):
    """The quick shard tier over four logical shards of the card: every
    gate passes, its shards launch B1's grid form, and the live stats
    bill the quick set's plan (2 buckets, 1249 useful rows in 2176
    padded, 3200 fused)."""
    from jepsen_tpu_torch.checker.shard_bench import run_shard_tier
    from jepsen_tpu_torch.distributed import ShardMesh

    g0 = lk.BATCH_LAUNCHES
    out = run_shard_tier(quick=True, mesh=ShardMesh(["cuda:0"] * 4),
                         out_path=str(tmp_path / "shard.json"))
    assert out["parity"] and out["explain_match"], out.get("explain_diffs")
    assert out["steady_state_compile_misses"] == 0
    assert out["warmup"]["compiled"] == 0 and out["warmup"]["verified"]
    assert lk.BATCH_LAUNCHES > g0
    b = out["bucketed"]
    assert b["n_buckets"] == 2
    assert sum(x["useful_ops"] for x in b["buckets"]) == 1249
    assert sum(x["padded_ops"] for x in b["buckets"]) == 2176
    assert out["fused_counterfactual"]["padded_ops"] == 3200


@pytest.mark.cuda
def test_corpus_replay_on_the_card(cuda, tmp_path):
    """A two-entry pool (a corrupted register history with its minimal
    repro and a valid one) replayed with ``device="cuda"``: every route
    agrees, and the direct and bucketed routes ran B1."""
    from jepsen_tpu_torch.checker.seq import check_opseq
    from jepsen_tpu_torch.live import corpus

    model = cas_register()
    for seed, corrupt in ((9000, True), (9001, False)):
        rng = random.Random(seed)
        h = register_history(rng, n_ops=110, n_procs=6, overlap=5,
                             crash_p=0.03, max_crashes=3, n_values=4)
        if corrupt:
            h = corrupt_read(rng, h, at=0.8)
        valid = check_opseq(encode_ops(h, model.f_codes), model)["valid"]
        corpus.bank_cell({"model": model, "history": h},
                         {"family": "kv", "nemesis": "partition",
                          "valid": valid}, base=str(tmp_path))
    pool = corpus.load_pool(corpus.corpus_dir(str(tmp_path)))
    assert len(pool) == 2 and any(e.get("minimal") for e in pool)
    s0, g0 = lk.LAUNCHES, lk.BATCH_LAUNCHES
    out = corpus.corpus_replay(corpus.corpus_dir(str(tmp_path)),
                               device="cuda")
    assert out["ok"], out["failures"]
    assert lk.LAUNCHES > s0 and lk.BATCH_LAUNCHES > g0
    assert any(e["direct"] == "device-bfs(cuda)" for e in out["engines"])
    assert any(e["bucketed"] == "device-batch(cuda)"
               for e in out["engines"])


@pytest.mark.cuda
def test_analyze_cli_explain_on_the_card(cuda, tmp_path):
    """``python -m jepsen_tpu_torch.analyze --explain --device cuda`` on a
    stored history prints the plan ``explain(device="cuda")`` makes in
    process, and launches nothing."""
    import json
    import subprocess
    import sys

    from jepsen_tpu_torch import store
    from jepsen_tpu_torch.analyze.plan import explain

    rng = random.Random(9000)
    h = register_history(rng, n_ops=110, n_procs=6, overlap=5,
                         crash_p=0.03, max_crashes=3, n_values=4)
    path = store.write_history({"store_base": str(tmp_path), "name": "cli",
                                "start_time": "t"}, h)
    p = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch.analyze", path, "--model",
         "cas-register", "--explain", "--json", "--device", "cuda"],
        capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr
    plan = json.loads(p.stdout)["plan"]
    before = lk.LAUNCHES, lk.BATCH_LAUNCHES
    want = explain(store.read_history(path), cas_register(), device="cuda")
    assert (lk.LAUNCHES, lk.BATCH_LAUNCHES) == before
    assert plan == json.loads(json.dumps(want, default=str))


@pytest.mark.cuda
def test_live_kv_history_checked_on_the_card(cuda, tmp_path):
    """A short run against the port's kv daemon (4 clients, 200 ops),
    checked on the card with ``algorithm="device"`` and by the host
    engine: both valid."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs

    port = cs._free_port()
    proc = cs._spawn_daemon("kv_server", port, tmp_path / "kv")
    try:
        h = cs._join_clients(*cs._live_clients(
            [port], 4, 200, (1, 2, 3, 4, 5), rate=100.0))
    finally:
        cs._kill9(proc)
    model = cas_register(cs.LIVE_MISSING)
    test = {"name": "live", "store_base": str(tmp_path)}
    dev = lin.linearizable(model, algorithm="device",
                           device="cuda").check(test, h)
    host = lin.linearizable(model, algorithm="host",
                            device="cpu").check(test, h)
    assert dev["valid"] is True and host["valid"] is True


@pytest.mark.cuda
def test_composed_keyed_check_on_the_card(cuda, tmp_path):
    """The stored keyed test of ``chip_smoke.phase_checkers`` at 32 keys
    of the batch256 tier: saved, loaded, checked by ``compose`` of the
    lifted linearizability checker (B1-T's grid) and the lifted
    timeline, every 4th key invalid, the valid keys' configs the JAX
    package's (``BATCH256_CONFIGS``), one timeline page per key."""
    import os
    import sys
    from dataclasses import replace

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs

    from jepsen_tpu_torch import independent, store
    from jepsen_tpu_torch.checker import compose

    n = 32
    keyed, model = cs.keyed_history(n)
    test = {**cs.CHECKERS_TEST, "store_base": str(tmp_path)}
    store.save_1(test, [replace(op, time=i * 1_000_000,
                                value=[op.value.key, op.value.value])
                        for i, op in enumerate(keyed)])
    run = store.load(test["name"], test["start_time"], str(tmp_path))
    history = [replace(op, value=independent.tuple_(*op.value))
               for op in run["history"]]
    before = lk.BATCH_LAUNCHES
    res = compose({"linear": independent.checker(
                       lin.Linearizable(model, device="cuda")),
                   "timeline": independent.checker(
                       cs._timeline_per_key())}).check(run, history)
    assert lk.BATCH_LAUNCHES > before
    assert res["valid"] is False
    assert sorted(res["linear"]["failures"]) == list(range(0, n, 4))
    for k in range(n):
        r = res["linear"]["results"][k]
        assert r["valid"] is (k % 4 != 0)
        if r["valid"]:
            assert (r["configs"], r["max_depth"]) == (
                cs.BATCH256_CONFIGS[k], cs.BATCH256_DEPTH[k])
        assert os.path.getsize(os.path.join(store.path(
            test, "independent", str(k)), "timeline.html")) > 0
    store.save_2(test, res)
    assert store.latest(str(tmp_path))["results"]["valid"] is False


@pytest.mark.cuda
def test_devlint_on_the_card(cuda):
    """``python -m jepsen_tpu_torch.analyze --devlint --json`` on the
    card in a fresh process: the fused kernel's routes clean with their
    compile spans captured, the findings exactly
    ``chip_smoke.DEVLINT_FINDINGS``, exit 1, B1 launched."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    import chip_smoke as cs

    p = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch.analyze", "--devlint",
         "--json"], capture_output=True, text=True, timeout=600, cwd=repo)
    rep = json.loads(p.stdout)
    assert p.returncode == 1, p.stderr
    assert {tuple(f) for f in rep["findings"]} == cs.DEVLINT_FINDINGS
    assert tuple(rep["routes"]) == cs.DEVLINT_ROUTES
    assert all(rep["spans"][r] > 0 for r in cs.DEVLINT_B1_ROUTES)
    assert rep["launches"]["single,on"] > 0 and \
        rep["launches"]["grid,on"] > 0


@pytest.mark.cuda
def test_stream_gate_on_the_card(cuda):
    """``chip_smoke``'s ``stream[gate]`` burst on the card at the default
    gate and ``STREAM_GATE_BUDGET``: the gated segment's fold launches
    B1, is undecided, and the checker sweeps the segment on the host to
    the states the card's fold reaches at a budget that decides it."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs

    from jepsen_tpu_torch.decompose import engine
    from jepsen_tpu_torch.stream import StreamChecker
    from jepsen_tpu_torch.stream import device as sd

    h, model = cs.stream_gate_history()
    folds, sweeps = [], []
    fold, sweep = sd.device_fold_states, engine.segment_states

    def traced_fold(sseq, m, ins, **kw):
        out = fold(sseq, m, ins, **kw)
        folds.append((sseq, set(ins), out))
        return out

    def traced_sweep(sseq, *a, **kw):
        out = sweep(sseq, *a, **kw)
        sweeps.append((len(sseq), out[0] if isinstance(out, tuple) else out))
        return out

    sd.device_fold_states, engine.segment_states = traced_fold, traced_sweep
    try:
        before = lk.LAUNCHES + lk.BATCH_LAUNCHES
        sc = StreamChecker(model, device="cuda",
                           device_budget=cs.STREAM_GATE_BUDGET)
        for op in h:
            sc.ingest(op)
        res = sc.finalize()
        launched = lk.LAUNCHES + lk.BATCH_LAUNCHES - before
    finally:
        sd.device_fold_states, engine.segment_states = fold, sweep
    assert res["valid"] is True and not res["stream"]["fallback"]
    assert len(folds) == 1 and folds[0][2] is None and launched > 0
    sseq, ins, _ = folds[0]
    decided = fold(sseq, model, ins, budget=cs.STREAM_KW["device_budget"],
                   device="cuda")
    want = {(100 + i,) for i in range(cs.STREAM_GATE["n_writes"])}
    assert [s for n, s in sweeps if n == len(sseq)] == [want]
    assert decided is not None and decided[0] == want


@pytest.mark.cuda
def test_queue_linearizable_device_leg_on_the_card(cuda, tmp_path):
    """``chip_smoke.queue_linear_device_leg`` on the card: the JAX
    package's verdict from the torch step alone, its slices on the card,
    no B1 launch (the queue models are not the kernel's)."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs

    before = lk.LAUNCHES + lk.BATCH_LAUNCHES
    out, slices, requests = cs.queue_linear_device_leg(str(tmp_path),
                                                       device="cuda")
    card = str(lin._resolve_device("cuda"))
    assert out["valid"] is \
        cs.CHECKERS_REFERENCE["queue_linearizable/valid"]
    assert requests > 0 and set(slices) == {card} and slices[card] > 0
    assert lk.LAUNCHES + lk.BATCH_LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("liars", [(), (2, 5)])
def test_core_run_register_on_the_card(cuda, tmp_path, liars):
    """``chip_smoke.phase_run``'s register test at 8 keys through the
    port's ``core.run`` with the streaming checker on the card: every
    op completed, the dummy remote's commands the JAX package's, and
    each key's verdict (the tutorial's lifted composition: a race of
    the host engines and B1-T's single-key form, never the grid) the
    host's on the stored history."""
    import os
    import sys
    from dataclasses import replace

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs

    from jepsen_tpu_torch import core, store
    from jepsen_tpu_torch.independent import subhistory

    random.seed(14)
    base = str(tmp_path)
    test = cs.run_test(cs.run_checker(), liars=liars, keys=8,
                       concurrency=20) | {
        "name": "run-card", "store_base": base, "stream": True,
        "device": "cuda"}
    before = lk.BATCH_LAUNCHES
    out = core.run(test)
    h = out["history"]
    assert all(op.index == i for i, op in enumerate(h))
    assert sum(isinstance(op.process, int) for op in h) == 2 * 8 * 100
    assert cs.nemesis_commands(out["remote"]) == cs.RUN_NEMESIS_COMMANDS
    res = out["results"]
    # the lifted composition checks key by key (ROADMAP.md section C)
    assert lk.BATCH_LAUNCHES == before
    assert not cs._error_paths(res)
    assert res["valid"] is (not liars) is out["stream_results"]["valid"]
    assert sorted(res["failures"]) == sorted(liars)
    stored = [replace(op, value=cs.stored_kv(op.value))
              if isinstance(op.process, int) else op
              for op in store.load("run-card", out["start_time"],
                                   base)["history"]]
    host = lin.linearizable(cas_register(0), device="cpu")
    for k in range(8):
        want = host.check({"store_base": base}, subhistory(k, stored), {})
        assert res["results"][k]["linear"]["valid"] is want["valid"]
        assert res["results"][k]["timeline"]["valid"] is True


@pytest.mark.cuda
@pytest.mark.parametrize("volatile", [False, True])
def test_suite_lock_runs_on_the_card(cuda, tmp_path, volatile):
    """A suite's whole test through its command line on the card, then
    localnode's lock server under the staged double grant: the flags
    reach the suite-built checker (``--lin-algorithm device --no-hb``:
    the search on B1-T, not the prepass), and each verdict is the host's
    on the stored history."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs

    from jepsen_tpu_torch import cli, core, store
    from jepsen_tpu_torch import generator as gen
    from jepsen_tpu_torch.suites import atomdemo, localnode

    base = str(tmp_path)
    rc = cli.run(cli.single_test_cmd(
        lambda opts: atomdemo.atom_test(opts) | {"store_base": base},
        add_opts=atomdemo.add_opts),
        ["test", "--dummy", "-n", "n1", "--time-limit", "2",
         "--lin-algorithm", "device", "--no-hb"])
    assert rc == cli.EXIT_OK
    run = store.latest(base)
    assert run["device"] == "cuda" and run["results"]["valid"] is True
    test = localnode.locknode_test({
        "base_port": cs._run_ports(1), "store_base": base,
        "data_root": str(tmp_path / "nodes"), "lock_volatile": volatile,
        "concurrency": 2, "lin_algorithm": "device", "hb": False})
    test["generator"] = cs.double_grant_generator(gen)
    before = lk.LAUNCHES
    lin_res = core.run(test)["results"]["linear"]
    want = lin.linearizable(mutex(), device="cpu").check(
        {"store_base": str(tmp_path / "host")},
        store.latest(base)["history"])
    assert lin_res["valid"] is want["valid"] is (not volatile)
    if volatile:
        assert lin_res["engine"].startswith("device-bfs(cuda)")
        assert lk.LAUNCHES > before


@pytest.mark.cuda
def test_kernel_launches_from_threads_at_different_plans(cuda):
    """Keys checked in parallel threads (the independent checker's
    ``bounded_pmap``) launch one kernel instantiation at plans of
    different shared memory at once: no launch fails, and each thread's
    last slice equals the same slice launched alone.  Without the kernel's
    lock around setting its shared-memory limit and launching, a launch
    now and then failed with "invalid argument"."""
    import threading

    model = cas_register()
    setups = []
    for seed, frontier in enumerate([16, 128, 512, 2048]):
        h = register_history(random.Random(seed), n_ops=200, n_procs=12,
                             overlap=10, crash_p=0.06, max_crashes=6,
                             n_values=3)
        seq = encode_ops(h, model.f_codes)
        es = enc.encode_search(seq)
        dims = enc.choose_dims(es, model, device=cuda, frontier=frontier)
        esp = enc.pad_search(es, dims.n_det_pad, dims.n_crash_pad)
        args = enc.search_args(esp, es, device=cuda)
        carry = enc.carry_to_device(enc._init_carry(dims, model), cuda)
        setups.append((dims, args, carry))
    assert len({lk.launch_plan(d, cuda, telemetry=True)["smem_bytes"]
                for d, _, _ in setups}) > 1

    def launch(dims, args, carry):
        return lk.level_loop(model, dims, *args, 10**8, 8, False, *carry,
                             telemetry=True)

    def host(out):
        return [int(v) for v in out[1:6]], out[0][:int(out[1])].cpu()

    alone = [host(launch(*s)) for s in setups]
    last = [None] * (2 * len(setups))
    errors = []

    def work(t):
        # no host read between launches, as between a search's slices
        for _ in range(300):
            try:
                last[t] = launch(*setups[t % len(setups)])
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append(repr(e))

    threads = [threading.Thread(target=work, args=(t,))
               for t in range(len(last))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == [], errors[:3]
    for t, out in enumerate(last):
        ids, rows = host(out)
        want = alone[t % len(setups)]
        assert ids == want[0] and torch.equal(rows, want[1]), t


@pytest.mark.cuda
def test_campaign_cell_checked_on_the_card(cuda, tmp_path):
    """One live campaign cell, replicated x kill-restart (three real
    replicas under kill -9 and restart), its history checked on B1-T:
    ok, valid, audited, and decided by the device search."""
    import json
    import os
    import socket

    from jepsen_tpu_torch.live.campaign import run_campaign

    rng = random.Random()
    while True:
        base = rng.randrange(20000, 31000)
        socks = []
        try:
            for i in range(3):
                socks.append(socket.socket())
                socks[-1].bind((f"127.0.1.{i + 1}", base + i))
            break
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    record = run_campaign(
        {"time_limit": 5, "rate": 100, "lin_algorithm": "device",
         "store_base": str(tmp_path / "store"),
         "data_root": str(tmp_path / "nodes"), "base_port": base,
         "cell_retries": 0},
        families=["replicated"], nemeses=["kill-restart"], seeded=False)
    [cell] = record["cells"]
    assert cell["status"] == "ok" and cell["attempts"] == 1, cell
    assert cell["valid"] is True and cell["audit"]["ok"] is True, cell
    assert cell["faults"] >= 1
    with open(os.path.join(cell["store"], "results.json")) as f:
        linear = json.load(f)["linear"]
    assert linear["engine"].startswith("device-bfs(cuda"), linear["engine"]


@pytest.mark.cuda
def test_fuzz_cas_register_on_the_card(cuda):
    """Eight differential fuzz rounds of cas-register with the audit,
    the device leg on the card: no divergence, no W-code, and B1 ran."""
    from jepsen_tpu_torch.fuzz import fuzz

    before = lk.LAUNCHES
    rec = fuzz("cas-register", rounds=8, audit=True, out=None,
               device="cuda")
    assert rec["rounds"] == 8 and rec["encode_errors"] == 0, rec
    assert rec["divergence"] is None and rec["audit_failures"] == [], rec
    assert lk.LAUNCHES > before, rec
    assert any(e.startswith("device-bfs(cuda") for e in rec["engines"]), rec
