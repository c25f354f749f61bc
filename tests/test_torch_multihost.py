"""The port's multi-host mode on the CPU (counterpart of tests/test_multihost.py
and of tests/test_parallel.py's single-host no-op).

  * ``initialize_multihost`` without a coordinator is a no-op, and the
    global layout is one process with its devices;
  * two processes join a ``gloo`` group through ``initialize_multihost`` on
    a localhost coordinator and reduce across it;
  * two processes each build ``read_system_config``'s MultiSeqSystem under
    a ``"multihost"`` block (B=4, 2 sequences each, 4 rounds, the
    histogram-peak provider fed every round the batch-summed histograms):
    each process's rounds and final state equal the
    one-process MultiSeqSystem's for the same global sequences, and the
    provider's state is the same on both processes and in the one-process
    run;
  * a round whose fetch fails on one process only is recorded failed on
    both, both recover alike, and both go on equal to the one-process run
    with the same failure;
  * an unreachable coordinator raises within its timeout.

Each child process runs its torch ops on one intra-op thread
(tests/test_torch_spatial.py says why), and is killed if it outlives the
test's timeout (longer than gloo's).  The coordinator's port is reserved
(``_reserved_port``) until the children have ended: a port that was only
found free could be taken by any other process (the other test workers
spawn their own coordinators) before process 0's store binds it.
"""

import contextlib

import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import torch

from cartslam_tpu_torch.config import build_system
from cartslam_tpu_torch.parallel.distributed import (
    global_data_layout, global_device_count, initialize_multihost)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST = "127.0.0.1"  # an address, so that every process takes the same family
B, ROUNDS, FAIL_ROUND = 4, 4, 2
GLOO_TIMEOUT_S = 60
CHILD_TIMEOUT_S = 150
SOURCE = {"type": "synthetic", "image_size": [32, 128], "num_frames": ROUNDS, "seed": 3}
MODULES = [
    {"type": "disparity", "num_disparities": 48, "min_disparity": 1},
    {"type": "disparity_derivative"},
    {"type": "depth"},
    {"type": "disparity_planeseg", "parameter_provider": {"type": "histogram_peak"},
     "update_interval": 2},
]
HIST = "planeseg_frame_histogram"
KEYS = ["disparity", "depth", "planes", HIST]

CHILD = r"""
import json, pickle, sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, {repo!r})
args = json.loads(sys.argv[1])
multihost = {{"coordinator": f"{host}:{{args['port']}}", "num_processes": args["procs"],
             "process_id": args["pid"], "timeout": args.get("timeout", {gloo})}}
if args["mode"] == "unreachable":
    from cartslam_tpu_torch.parallel.distributed import initialize_multihost
    try:
        initialize_multihost(multihost)
    except Exception as e:
        print("RAISED", type(e).__name__, flush=True)
    sys.exit(0)
if args["mode"] == "reduce":
    import torch.distributed as dist
    from cartslam_tpu_torch.parallel.distributed import (all_gather, global_data_layout,
                                                         global_device_count,
                                                         initialize_multihost)
    assert initialize_multihost(multihost) and initialize_multihost(multihost)
    layout = global_data_layout("cpu")
    assert (layout.process_count, layout.process_index) == (2, args["pid"]), layout
    assert global_device_count("cpu") == 2 and layout.share(4) == range(2 * args["pid"],
                                                                        2 * args["pid"] + 2)
    x = torch.arange(4, dtype=torch.int64) + 4 * args["pid"]
    dist.all_reduce(x)
    assert x.tolist() == [4, 6, 8, 10], x
    assert all_gather({{"pid": args["pid"]}}) == [{{"pid": 0}}, {{"pid": 1}}]
    print("REDUCE_OK", args["pid"], flush=True)
    sys.exit(0)
from cartslam_tpu_torch.config import read_system_config
system = read_system_config(args["config"], device="cpu", extra_fetch_keys={keys!r},
                            max_in_flight=2, snapshot_interval=1,
                            parallel=dict(args["parallel"], multihost=multihost))
if args.get("fail_pid") == args["pid"]:
    orig, calls = system._fetch_with_timeout, []
    def faulty(staged):
        calls.append(1)
        if len(calls) == {fail}:
            raise RuntimeError("injected fetch failure")
        return orig(staged)
    system._fetch_with_timeout = faulty
seen = {{}}
n = system.run(on_frame=lambda fid, out: seen.update({{fid: dict(out)}}))
provider = next(m for m in system.pipeline.modules if m.host_fetch_reduce()).host_state()
with open(args["out"], "wb") as f:
    pickle.dump(dict(n=n, seen=seen, state=system.final_state, failed=system.failed_frames,
                     provider=provider, first=system.first, batch=system.batch), f)
print("RUN_OK", args["pid"], flush=True)
"""


@contextlib.contextmanager
def _reserved_port():
    """A free port of HOST, held bound while the block runs.  The socket
    has SO_REUSEADDR and never listens, so the coordinator's store (which
    sets SO_REUSEADDR too) can bind and listen on the port, while no other
    process can bind it and a connection to it is refused until the store
    listens."""
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((HOST, 0))
        yield s.getsockname()[1]


def _spawn(args_list: list[dict]) -> list[str]:
    """The child processes, one per args dict, run to their end (killed
    after CHILD_TIMEOUT_S); returns their outputs, each asserted rc 0."""
    code = CHILD.format(repo=REPO, host=HOST, gloo=GLOO_TIMEOUT_S, keys=KEYS, fail=FAIL_ROUND)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, json.dumps(a)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for a in args_list]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def _config(tmp_path) -> str:
    path = tmp_path / "multiseq.json"
    path.write_text(json.dumps({"data_source": SOURCE, "modules": MODULES,
                                "parallel": {"mode": "multiseq", "batch": B}}))
    return str(path)


def _two_processes(tmp_path, fail_pid=None) -> list[dict]:
    cfg = _config(tmp_path)
    with _reserved_port() as port:
        args = [dict(mode="run", port=port, procs=2, pid=pid, config=cfg, fail_pid=fail_pid,
                     parallel={"mode": "multiseq", "batch": B},
                     out=str(tmp_path / f"p{pid}.pkl"))
                for pid in range(2)]
        _spawn(args)
    out = []
    for a in args:
        with open(a["out"], "rb") as f:
            out.append(pickle.load(f))
    return out


def _one_process(fail_round=None):
    """The one-process MultiSeqSystem over the same config, the same
    failure injected on its fetch of round `fail_round`."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        system = build_system(SOURCE, MODULES, device="cpu", extra_fetch_keys=KEYS,
                              max_in_flight=2, snapshot_interval=1,
                              parallel={"mode": "multiseq", "batch": B})
        if fail_round is not None:
            orig, calls = system._fetch_with_timeout, []

            def faulty(staged):
                calls.append(1)
                if len(calls) == fail_round:
                    raise RuntimeError("injected fetch failure")
                return orig(staged)
            system._fetch_with_timeout = faulty
        seen = {}
        system.run(on_frame=lambda fid, out: seen.update({fid: dict(out)}))
        provider = next(m for m in system.pipeline.modules if m.host_fetch_reduce()).host_state()
        return seen, system.final_state, system.failed_frames, provider
    finally:
        torch.set_num_threads(prev)


def _equal(a, b, where):
    if isinstance(b, dict):
        assert set(a) == set(b), where
        for k in b:
            _equal(a[k], b[k], f"{where}/{k}")
        return
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=where)


def _assert_matches_one_process(procs: list[dict], want) -> None:
    seen, state, failed, provider = want
    for pid, r in enumerate(procs):
        share = slice(2 * pid, 2 * pid + 2)
        assert (r["first"], r["batch"]) == (share.start, 2)
        assert r["failed"] == failed
        assert sorted(r["seen"]) == sorted(seen) and r["n"] == 2 * len(seen)
        for fid in seen:
            _equal(r["seen"][fid], {k: v[share] for k, v in seen[fid].items()},
                   f"process {pid} round {fid}")
        _equal(r["state"], {"modules": {m: {k: v[share] for k, v in ms.items()}
                                        for m, ms in state["modules"].items()},
                            "history": {k: v[share] for k, v in state["history"].items()}},
               f"process {pid} final state")
        _equal(r["provider"], provider, f"process {pid} provider")


def test_initialize_multihost_noop_on_single_host():
    assert initialize_multihost({}) is False
    assert initialize_multihost(None) is False
    layout = global_data_layout("cpu")
    assert (layout.process_count, layout.process_index) == (1, 0)
    assert layout.local_devices == [torch.device("cpu")]
    assert global_device_count("cpu") == 1 and layout.share(3) == range(3)


def test_two_process_gloo_reduction():
    with _reserved_port() as port:
        outs = _spawn([dict(mode="reduce", port=port, procs=2, pid=pid) for pid in range(2)])
    for pid, out in enumerate(outs):
        assert f"REDUCE_OK {pid}" in out, out


def test_two_process_multiseq_equals_one_process(tmp_path):
    procs = _two_processes(tmp_path)
    want = _one_process()
    assert not want[2] and sorted(want[0]) == list(range(1, ROUNDS + 1))
    _assert_matches_one_process(procs, want)
    # The sequences differ, and the provider of each process summed all
    # four sequences' histograms of rounds 2..4 (it resets after its update
    # at round 1): two of them came from the other process.
    seen = want[0]
    assert not np.array_equal(seen[ROUNDS]["disparity"][0], seen[ROUNDS]["disparity"][2])
    total = sum(r["seen"][fid][HIST].astype(np.int64).sum(axis=0)
                for r in procs for fid in range(2, ROUNDS + 1))
    assert total.any()
    for r in procs:
        np.testing.assert_array_equal(r["provider"]["running_hist"], total)


def test_round_failed_on_one_process_fails_on_both(tmp_path):
    procs = _two_processes(tmp_path, fail_pid=1)
    want = _one_process(fail_round=FAIL_ROUND)
    assert want[2] == [FAIL_ROUND]
    _assert_matches_one_process(procs, want)


def test_unreachable_coordinator_raises():
    """Process 1 of 2 with nothing listening on the coordinator's port: the
    start-up raises after its 2 s timeout (the child's own limit is far
    longer), and never runs as one process."""
    with _reserved_port() as port:
        out = _spawn([dict(mode="unreachable", port=port, procs=2, pid=1, timeout=2)])[0]
    assert "RAISED" in out, out
