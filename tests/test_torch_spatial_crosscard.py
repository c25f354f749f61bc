"""The spatial step captured across cards, on the CPU.

  * ``graphs.capture_cards``, the rule that names the cards one capture
    spans (home first, each other card once) and that the System captures
    (on a card, whatever cards the shards sit on; eagerly on the CPU and
    under module timing), on ``torch.device("cuda", i)`` objects with no
    card;
  * the body the capture records, with 4 row shards listed on two devices
    (both the CPU here, placed floor(i k / n) as on the cards), over static
    buffers, against ``SpatialPipeline.step`` on every output and state
    leaf of frames 1..5 (frame 4 the reset); and driven through the
    System's captured path (static buffers, host params loaded when they
    change, outputs staged from the buffers) with the histogram-peak
    provider at 4 in flight, against the eager spatial System and the JAX
    System on every fetched key of 6 frames and the final state (the JAX
    System run as tests/test_torch_spatial_system.py runs it: the full
    frame, unjitted, without the flow and the temporal vote);
  * a capture across devices that fails raises ``CaptureError`` and runs
    no frame eagerly; the graph pools of a capture's other cards are
    routed for the capture alone and released once;
  * a kernel wrapper called with another card current runs with its
    tensors' card current (``kernels/build.on_its_card``).

32x64 frames.
"""

import contextlib
import types

import jax
import numpy as np
import pytest
import torch
from test_torch_faithful import _one_intra_op_thread, eager_jax_relax  # noqa: F401 (fixtures)
from test_torch_slice import _assert_tree_equal
from test_torch_spatial_system import (
    FRAMES,
    MODULES,
    SYSTEM_KEYS,
    SYSTEM_MODULES,
    _assert_same,
    _images,
    _numpy,
    _source,
)

from cartslam_tpu.config import build_system as jax_build_system
from cartslam_tpu.sources.synthetic import SyntheticDataSource as JSource
from cartslam_tpu_torch.config import build_pipeline
from cartslam_tpu_torch.kernels import build
from cartslam_tpu_torch.parallel.group import ShardGroup
from cartslam_tpu_torch.parallel.spatial_flagship import SpatialPipeline
from cartslam_tpu_torch.runtime import graphs
from cartslam_tpu_torch.runtime.graphs import (
    CaptureError,
    StaticBuffers,
    _sequence_body,
    capture_cards,
)
from cartslam_tpu_torch.runtime.system import System
from cartslam_tpu_torch.sources import SyntheticDataSource as TSource

SHARDS = 4
LISTED = ["cpu", "cpu"]  # the devices the shards are placed on


def _cuda(*indices):
    return [torch.device("cuda", i) for i in indices]


def _placed(n: int, cards: int) -> list:
    """Shard i's card, floor(i k / n) of k, as SpatialPipeline places them."""
    return _cuda(*[i * cards // n for i in range(n)])


@pytest.mark.parametrize("home, devices, cards", [
    (torch.device("cuda", 0), _placed(8, 1), _cuda(0)),
    (torch.device("cuda", 0), _placed(8, 4), _cuda(0, 1, 2, 3)),
    (torch.device("cuda", 0), _placed(4, 4), _cuda(0, 1, 2, 3)),
    (torch.device("cuda", 2), _cuda(2, 2, 3, 3), _cuda(2, 3)),
    (torch.device("cuda", 1), _cuda(0, 0, 2, 2), _cuda(1, 0, 2)),
    (torch.device("cuda", 0), (), _cuda(0)),
    (torch.device("cpu"), [torch.device("cpu")] * 4, []),
])
def test_capture_cards(home, devices, cards):
    """Home first, then each other card once in shard order; nothing on
    the CPU."""
    assert capture_cards(home, devices) == cards


def test_capture_cards_refuses_mixed_types():
    with pytest.raises(ValueError, match="cannot also run on cpu"):
        capture_cards(torch.device("cuda", 0), [torch.device("cuda", 0), torch.device("cpu")])


def _stub(home, devices):
    """What the System reads of a pipeline at construction."""
    return types.SimpleNamespace(ctx=types.SimpleNamespace(device=home, grayscale=False),
                                 devices=devices, host_fetch_keys=lambda: ())


@pytest.mark.parametrize("shards, cards", [(8, 4), (4, 4), (8, 2), (8, 1)])
@pytest.mark.parametrize("module_timing", [False, True])
def test_system_captures_across_cards(shards, cards, module_timing):
    """A spatial System on a card is captured whatever cards its shards
    sit on (the group's placement, its collectives event joins across
    cards), and runs eagerly under module timing."""
    group = ShardGroup(shards, _placed(shards, cards))
    assert group.per_shard == (cards > 1)
    system = System(None, _stub(torch.device("cuda", 0), group.devices),
                    module_timing=module_timing)
    assert system.captured == (not module_timing)
    assert capture_cards(system.device, group.devices) == _cuda(*range(cards))


def test_system_on_the_cpu_is_eager():
    system = System(None, _stub(torch.device("cpu"), [torch.device("cpu")] * SHARDS))
    assert not system.captured


def _listed(modules) -> SpatialPipeline:
    """A SpatialPipeline of SHARDS shards placed on the LISTED devices."""
    pipe, _ = build_pipeline(_source(TSource), modules, device="cpu",
                             parallel={"mode": "spatial", "devices": SHARDS})
    listed = SpatialPipeline(pipe.ctx, pipe.modules, SHARDS, LISTED)
    assert listed.devices == [torch.device("cpu")] * SHARDS
    assert capture_cards(listed.ctx.device, listed.devices) == []
    return listed


def test_crosscard_body_equals_the_step():
    """The captured body over static buffers against SpatialPipeline.step
    on every output and state leaf, frames 1..5 (the initial, normal and
    reset variants), the flow and the temporal vote included."""
    pipe = _listed(MODULES)
    keys = frozenset(k for m in pipe.modules for k in m.provides())
    source = _source(TSource)
    frame = source.get_next()
    bufs = StaticBuffers(pipe, frame)
    assert bufs.cards == [] and bufs.pool is None
    params = pipe.init_host_params()
    state = pipe.init_state()
    variants = set()
    for fid in range(1, 6):
        variant = pipe.variant(fid)
        variants.add(variant)
        images = _images(frame)
        bufs.load_frame(images, fid)
        got = _numpy(_sequence_body(pipe, bufs, bufs.state, bufs.frame, variant, keys))
        state, want = pipe.step(state, {**images, "frame_id": fid}, params, variant)
        assert set(got) == keys
        _assert_same(got, _numpy(want), f"frame {fid} outputs")
        _assert_same(_numpy(bufs.state), _numpy(state), f"frame {fid} state")
        frame = source.get_next()
    assert len(variants) == 3


def _captured_on_the_cpu(system) -> list:
    """The System's captured path with the recorded body run eagerly in
    place of each replay; returns the variants it was asked for."""
    pipe, asked = system.pipeline, []

    def captured_step(variant, fetch_keys):
        asked.append(variant)
        bufs = pipe.static_buffers()
        return lambda: _sequence_body(pipe, bufs, bufs.state, bufs.frame, variant, fetch_keys)
    pipe.captured_step = captured_step
    system.captured = True
    return asked


def _collect(system):
    seen = {}
    n = system.run(on_frame=lambda fid, out: seen.update({fid: dict(out)}))
    assert n == len(seen) and not system.failed_frames
    return seen


def test_crosscard_system_matches_eager_and_jax():
    """The captured path over the listed shards against the eager spatial
    System and the JAX System: every fetched key of every frame and the
    final state; the provider's update from frame 1 reaches frame 5."""
    jsys = jax_build_system(_source(JSource), SYSTEM_MODULES, extra_fetch_keys=SYSTEM_KEYS,
                            max_in_flight=4)
    jpipe = jsys.pipeline
    jpipe.jitted_step = lambda variant, fetch_keys: jpipe.make_step(variant, fetch_keys)
    want = _collect(jsys)
    runs = {}
    for mode in ("captured body", "eager"):
        system = System(_source(TSource), _listed(SYSTEM_MODULES),
                        extra_fetch_keys=SYSTEM_KEYS, max_in_flight=4)
        assert not system.captured
        asked = _captured_on_the_cpu(system) if mode == "captured body" else []
        runs[mode] = (_collect(system), system.final_state)
        if asked:
            assert asked == [system.pipeline.variant(f) for f in range(1, FRAMES + 1)]
    got, state = runs["captured body"]
    assert sorted(got) == sorted(want) == list(range(1, FRAMES + 1))
    for fid in got:
        for name, ref in (("eager", runs["eager"][0][fid]), ("JAX", want[fid])):
            _assert_tree_equal({k: got[fid][k] for k in SYSTEM_KEYS},
                               {k: ref[k] for k in SYSTEM_KEYS}, f"frame {fid} vs {name}")
    _assert_tree_equal(state, runs["eager"][1], "final state vs eager")
    _assert_tree_equal(state, jax.tree.map(np.asarray, jsys.final_state), "final state vs JAX")
    assert (want[4]["planes"] == 2).all() and not (want[5]["planes"] == 2).all()


def test_failed_crosscard_capture_raises_and_runs_nothing_eagerly():
    """A System over the listed shards made to capture on the CPU: the
    capture fails, run() raises CaptureError, and no frame reaches
    on_frame or is recorded failed."""
    system = System(_source(TSource, frames=2), _listed(MODULES), max_in_flight=1)
    system.captured = True
    seen = []
    with pytest.raises(CaptureError, match="needs a CUDA device"):
        system.run(on_frame=lambda fid, out: seen.append(fid))
    assert not seen and not system.failed_frames


@pytest.mark.parametrize("fail", [False, True])
def test_pool_refs_route_for_the_capture_alone(monkeypatch, fail):
    """Each other card's pool is routed while the capture's block runs and
    the routing ends with it, also when the capture raises; the references
    go back once, however often release is called."""
    calls = []
    for name in ("_cuda_beginAllocateToPool", "_cuda_endAllocateToPool", "_cuda_releasePool"):
        monkeypatch.setattr(torch._C, name,
                            lambda i, pool, name=name: calls.append((name[6:], i, pool)),
                            raising=False)
    refs = graphs._PoolRefs(_cuda(1, 3), (0, 7))
    with pytest.raises(RuntimeError) if fail else contextlib.nullcontext():
        with refs.route():
            assert calls == [("beginAllocateToPool", 1, (0, 7)),
                             ("beginAllocateToPool", 3, (0, 7))]
            if fail:
                raise RuntimeError("the capture failed")
    assert calls[2:] == [("endAllocateToPool", 1, (0, 7)), ("endAllocateToPool", 3, (0, 7))]
    refs.release()
    refs.release()
    assert calls[4:] == [("releasePool", 1, (0, 7)), ("releasePool", 3, (0, 7))]



@pytest.mark.parametrize("first, current, entered", [
    (torch.device("cuda", 1), 0, [torch.device("cuda", 1)]),
    (torch.device("cuda", 2), 2, []),
    (torch.device("cpu"), 0, []),
])
def test_wrapper_runs_on_its_tensors_card(monkeypatch, first, current, entered):
    """The wrapper's body runs inside a device scope of its first tensor's
    card when another card is current, and as it is otherwise."""
    scopes, inside = [], []

    @contextlib.contextmanager
    def device(d):
        scopes.append(d)
        yield

    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    monkeypatch.setattr(torch.cuda, "device", device)

    @build.on_its_card
    def wrapper(t, x, *, k):
        inside.append(list(scopes))
        return x + k

    assert wrapper(types.SimpleNamespace(device=first), 1, k=2) == 3
    assert inside == [entered] and scopes == entered
