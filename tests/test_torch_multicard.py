"""The port's multi-device layouts on the CPU, where every listed device is
the CPU (the cards' copies and streams run only in chip_smoke.py):

  * ``MultiSeqSystem(devices=["cpu", "cpu"])``: two partitions, each with
    its own pipeline state and step, equal to one partition on every round
    and on the final state; a checkpoint written from two partitions
    resumed by one, equal to the uninterrupted run;
  * ``SpatialMultiSeqSystem`` with its (sequences x shards) grid on two
    listed devices: one partition a sequence, equal to one partition;
  * the shard group's stream options;
  * the ``SpatialFlagship`` preset: the JAX preset's module types and knobs,
    its steps equal to the config-built SpatialPipeline (2 shards, 2
    frames) on every output and the state, and its composed step equal to
    the single one for each sequence.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from cartslam_tpu.parallel.spatial_flagship import (
    SpatialFlagship as JSpatialFlagship, SpatialFlagshipConfig as JConfig)
from cartslam_tpu_torch.config import build_pipeline
from cartslam_tpu_torch.parallel.group import ShardGroup
from cartslam_tpu_torch.parallel.spatial_flagship import SpatialFlagship, SpatialFlagshipConfig
from cartslam_tpu_torch.parallel.system import MultiSeqSystem, SpatialMultiSeqSystem
from cartslam_tpu_torch.runtime.state import stack_trees, state_to_numpy
from cartslam_tpu_torch.sources import SyntheticDataSource

H, W, B, ROUNDS, CKPT_AT = 32, 128, 4, 4, 2
KEYS = ["disparity", "depth", "optflow", "planes"]
MODULES = [
    {"type": "disparity", "num_disparities": 48, "min_disparity": 1},
    {"type": "optflow", "levels": 2, "search": 2, "refine": 1},
    {"type": "disparity_derivative"},
    {"type": "depth"},
    {"type": "disparity_planeseg", "parameter_provider": {"type": "histogram_peak"},
     "update_interval": 2, "use_temporal_smoothing": True},
]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _sources(n=B, rounds=ROUNDS):
    return [SyntheticDataSource(image_size=(H, W), num_frames=rounds, seed=i) for i in range(n)]


def _run(system):
    seen = {}
    n = system.run(on_frame=lambda fid, out: seen.update({fid: dict(out)}))
    assert n == system.batch * len(seen) and not system.failed_frames
    return seen


def _equal(a, b, where):
    if isinstance(b, dict):
        assert set(a) == set(b), where
        for k in b:
            _equal(a[k], b[k], f"{where}/{k}")
        return
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=where)


def _multiseq(devices, rounds=ROUNDS, **kw):
    pipeline, _ = build_pipeline(_sources(1)[0], MODULES, device="cpu")
    return MultiSeqSystem(_sources(rounds=rounds), pipeline, devices=devices,
                          extra_fetch_keys=KEYS, max_in_flight=2, **kw)


@pytest.fixture(scope="module")
def one_partition():
    system = _multiseq(["cpu"])
    assert len(system.partitions) == 1 and system.partitions[0].pipeline is system.pipeline
    return _run(system), system.final_state


def test_two_partitions_equal_one(one_partition):
    want, want_state = one_partition
    system = _multiseq(["cpu", "cpu"])
    assert [(p.lo, p.hi) for p in system.partitions] == [(0, 2), (2, 4)]
    got = _run(system)
    assert sorted(got) == sorted(want) == list(range(1, ROUNDS + 1))
    for fid in want:
        _equal(got[fid], want[fid], f"round {fid}")
    _equal(system.final_state, want_state, "final state")
    assert not np.array_equal(got[ROUNDS]["disparity"][1], got[ROUNDS]["disparity"][2])
    # The device list drops to a divisor of B, as the JAX mesh does.
    assert len(_multiseq(["cpu"] * 3).partitions) == 2


def test_checkpoint_from_two_partitions_resumed_by_one(one_partition, tmp_path):
    want, want_state = one_partition
    ckpt = str(tmp_path / "state.npz")
    _run(_multiseq(["cpu", "cpu"], rounds=CKPT_AT, checkpoint_path=ckpt,
                   checkpoint_interval=CKPT_AT))
    resumed = _multiseq(["cpu"], resume_from=ckpt)
    got = _run(resumed)
    assert sorted(got) == list(range(CKPT_AT + 1, ROUNDS + 1))
    for fid in got:
        _equal(got[fid], want[fid], f"round {fid}")
    _equal(resumed.final_state, want_state, "final state")


def test_composed_grid_on_two_devices():
    """2 sequences x 2 shards: the grid on two listed devices puts each
    sequence on its own, two partitions, equal to one partition."""
    pipeline, _ = build_pipeline(_sources(1)[0], MODULES[:4], device="cpu",
                                 parallel={"mode": "spatial", "devices": 2})
    runs = {}
    for devices in (["cpu"], ["cpu", "cpu"]):
        system = SpatialMultiSeqSystem(_sources(2, rounds=2), pipeline, devices=devices,
                                       extra_fetch_keys=KEYS[:3])
        assert [(p.lo, p.hi) for p in system.partitions] == \
            ([(0, 2)] if len(devices) == 1 else [(0, 1), (1, 2)])
        runs[len(devices)] = (_run(system), system.final_state)
    _equal(runs[2][0], runs[1][0], "rounds")
    _equal(runs[2][1], runs[1][1], "final state")


def test_shard_group_streams():
    with pytest.raises(ValueError, match="streams"):
        ShardGroup(2, ["cpu", "cpu"], streams="bogus")
    # A stream per shard is a card's: the CPU's shards take turns on the host.
    assert not ShardGroup(2, ["cpu", "cpu"], streams="per_shard").per_shard


PRESET = dict(height=H, width=W, num_disparities=48, block_size=8, iterations=2,
              initial_iterations=3, flow_levels=2, flow_search=2, flow_refine=1)


def _config_modules(c: SpatialFlagshipConfig, ranges) -> list[dict]:
    """The preset's modules as a JSON module list."""
    return [
        {"type": "disparity", "num_disparities": c.num_disparities,
         "min_disparity": c.min_disparity, "smoothing_radius": c.smoothing_radius,
         "smoothing_iterations": c.smoothing_iterations},
        {"type": "disparity_derivative"},
        {"type": "depth"},
        {"type": "optflow", "levels": c.flow_levels, "search": c.flow_search,
         "refine": c.flow_refine, "base_level": c.flow_base_level,
         "med_passes": c.flow_med_passes},
        {"type": "superpixels", "block_size": c.block_size, "iterations": c.iterations,
         "initial_iterations": c.initial_iterations, "reset_iterations": c.reset_iterations},
        {"type": "superpixel_disparity_planeseg", "use_temporal_smoothing": True,
         "temporal_smoothing_distance": c.temporal_distance, "warp_mode": "select",
         "max_warp_y": c.max_warp_y, "max_warp_x": c.max_warp_x,
         "parameter_provider": {"type": "static", "horizontal_range_min": ranges[0][0],
                                "horizontal_range_max": ranges[0][1],
                                "vertical_range_min": ranges[1][0],
                                "vertical_range_max": ranges[1][1]}},
    ]


def _knobs(m) -> dict:
    return {k: v for k, v in vars(m).items()
            if not k.startswith("_") and isinstance(v, (bool, int, float, str, tuple))}


def test_spatial_flagship_preset():
    ranges = ((1, 30), (-3, 1))  # configs/modules/zed-planeseg.json's
    assert SpatialFlagshipConfig._fields == JConfig._fields
    assert SpatialFlagshipConfig(1, 1)._asdict() == JConfig(1, 1)._asdict()
    cfg = SpatialFlagshipConfig(**PRESET)
    source = SyntheticDataSource(image_size=(H, W), num_frames=2, seed=1, max_disparity=24.0,
                                 baseline=20.0)
    q = source.get_camera_intrinsics().q
    preset = SpatialFlagship(cfg, 2, q=q, ranges=ranges, device="cpu")
    jpreset = JSpatialFlagship(Mesh(np.array(jax.devices()[:2]), ("spatial",)),
                               JConfig(**PRESET), q=q, ranges=ranges)
    pipe, jpipe = preset.pipeline, jpreset.pipeline
    assert [type(m).__name__ for m in pipe.modules] == \
        [type(m).__name__ for m in jpipe.modules]
    compared = 0
    for m, jm in zip(pipe.modules, jpipe.modules):
        knobs, jknobs = _knobs(m), _knobs(jm)
        shared = set(knobs) & set(jknobs)
        assert {k: knobs[k] for k in shared} == {k: jknobs[k] for k in shared}, m.name
        compared += len(shared)
    assert compared >= 30, compared
    assert (preset.h_local, preset.num_labels) == (jpreset.h_local, jpreset.num_labels)

    config_pipe, _ = build_pipeline(source, _config_modules(cfg, ranges), device="cpu",
                                    parallel={"mode": "spatial", "devices": 2})
    frames = [source.get_next() for _ in range(2)]
    state = want_state = preset.init_state()
    params = config_pipe.init_host_params()
    steps = [preset.make_step("initial"), preset.make_step("normal")]
    for fid, (frame, step) in enumerate(zip(frames, steps), start=1):
        images = {k: torch.from_numpy(frame[k]) for k in ("left", "right")}
        state, out = step(state, {**images, "frame_id": fid}, preset.init_params())
        want_state, want = config_pipe.step(want_state, {**images, "frame_id": fid}, params,
                                            config_pipe.variant(fid))
        assert preset.variant(fid) == config_pipe.variant(fid)
        _equal({k: v.numpy() for k, v in out.items()}, {k: v.numpy() for k, v in want.items()},
               f"frame {fid}")
    _equal(state_to_numpy(state), state_to_numpy(want_state), "state")
    assert not (want["planes"].numpy() == 2).all()
    # The composed step: two sequences (the same frame twice) in one call,
    # each equal to the single step's.
    batched = preset.make_batched_step(2, "initial")
    images = {k: torch.from_numpy(np.stack([frames[0][k]] * 2)) for k in ("left", "right")}
    state2, out2 = batched(stack_trees([preset.init_state()] * 2), {**images, "frame_id": 1},
                           preset.init_params())
    _, out1 = steps[0](preset.init_state(), {**{k: v[0] for k, v in images.items()},
                                             "frame_id": 1}, preset.init_params())
    for b in range(2):
        _equal({k: v[b].numpy() for k, v in out2.items()}, {k: v.numpy() for k, v in out1.items()},
               f"batched sequence {b}")
