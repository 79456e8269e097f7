"""The port's multi-process runtime (devit_tpu_torch/runtime.py, device.py
and the rank gating in cli/common.py and train/meters.py), as
tests/test_runtime.py holds the JAX package's: the environment parsed into a
rendezvous with init_process_group mocked, the backend rules, the main
process's gates, and a real two-process gloo rendezvous whose stage-2 loss,
eval counters and stage-5 loss equal the one-process run within 1e-5
(relative)."""

import logging
import os

import numpy as np
import pytest
import torch

from devit_tpu_torch import device as dev_mod
from devit_tpu_torch import runtime
from devit_tpu_torch.parallel.launch import RankFailure, run_ranks

import torch_dist_worker as W

WORKER = os.path.join(os.path.dirname(__file__), "torch_dist_worker.py")
ENV = ("DEVIT_COORDINATOR", "DEVIT_MULTIHOST", "DEVIT_NUM_PROCESSES", "DEVIT_PROCESS_ID",
       "DEVIT_DIST_BACKEND", "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
       "MASTER_PORT", "SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID", "TORCHELASTIC_RUN_ID")


@pytest.fixture
def clean_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(runtime, "_DONE", False)
    calls = []
    monkeypatch.setattr(runtime.dist, "init_process_group",
                        lambda backend, **kw: calls.append(dict(kw, backend=backend)))
    return calls


def test_no_environment_no_group(clean_env, monkeypatch):
    # torchrun with one process asks for no group
    for k, v in {"TORCHELASTIC_RUN_ID": "x", "RANK": "0", "WORLD_SIZE": "1"}.items():
        monkeypatch.setenv(k, v)
    runtime.setup_runtime("cpu")
    runtime.setup_runtime("cpu")  # idempotent
    assert clean_env == []
    assert (runtime.rank(), runtime.world_size(), runtime.local_rank()) == (0, 1, 0)
    assert runtime.is_main_process() and not runtime.distributed()
    assert dev_mod.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("env,want", [
    ({"DEVIT_COORDINATOR": "10.0.0.1:1234", "DEVIT_NUM_PROCESSES": "4",
      "DEVIT_PROCESS_ID": "3"}, ("tcp://10.0.0.1:1234", 4, 3)),
    ({"DEVIT_MULTIHOST": "1", "RANK": "5", "WORLD_SIZE": "8", "LOCAL_RANK": "1",
      "MASTER_ADDR": "host0", "MASTER_PORT": "29500"}, ("tcp://host0:29500", 8, 5)),
    ({"DEVIT_MULTIHOST": "1", "SLURM_PROCID": "2", "SLURM_NTASKS": "16", "SLURM_LOCALID": "2",
      "MASTER_ADDR": "node7", "MASTER_PORT": "12345"}, ("tcp://node7:12345", 16, 2)),
    ({"DEVIT_MULTIHOST": "1", "SLURM_PROCID": "1", "SLURM_NTASKS": "2",
      "DEVIT_COORDINATOR": "node1:999"}, ("tcp://node1:999", 2, 1)),
    # a torchrun launch asks by itself
    ({"TORCHELASTIC_RUN_ID": "x", "RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1",
      "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "29501"}, ("tcp://127.0.0.1:29501", 2, 1)),
])
def test_environment_parsed_into_a_rendezvous(clean_env, monkeypatch, env, want):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    runtime.setup_runtime("cpu")
    (call,) = clean_env
    assert (call["init_method"], call["world_size"], call["rank"]) == want
    assert call["backend"] == "gloo"  # a CPU run


@pytest.mark.parametrize("env,match", [
    ({"DEVIT_MULTIHOST": "1"}, "neither torchrun"),
    ({"DEVIT_MULTIHOST": "1", "RANK": "0", "WORLD_SIZE": "2"}, "MASTER_ADDR"),
    ({"DEVIT_COORDINATOR": "h:1", "DEVIT_PROCESS_ID": "0"}, "DEVIT_NUM_PROCESSES"),
])
def test_incomplete_environment_raises(clean_env, monkeypatch, env, match):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match=match):
        runtime.setup_runtime("cpu")
    assert clean_env == []


def test_backend_rules_and_nccl_on_a_shared_card(clean_env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert runtime.backend_for("cuda") == "nccl" and runtime.backend_for("cpu") == "gloo"
    for k, v in {"DEVIT_COORDINATOR": "localhost:1", "DEVIT_NUM_PROCESSES": "2",
                 "DEVIT_PROCESS_ID": "1"}.items():
        monkeypatch.setenv(k, v)
    # rank 1 of two on a one-card host: NCCL refuses two ranks on one device
    with pytest.raises(RuntimeError, match="NCCL cannot run two ranks on one device"):
        runtime.setup_runtime("cuda")
    assert clean_env == []
    monkeypatch.setenv("DEVIT_DIST_BACKEND", "gloo")  # the one override
    runtime.setup_runtime("cuda")
    assert clean_env[0]["backend"] == "gloo"
    for bad, match in (("mpi", "expected one of"), ("nccl", "needs --device cuda")):
        monkeypatch.setenv("DEVIT_DIST_BACKEND", bad)
        with pytest.raises(ValueError, match=match):
            runtime.backend_for("cpu")


def test_rank_device_under_a_group(monkeypatch):
    picked = []
    monkeypatch.setattr(runtime, "distributed", lambda: True)
    monkeypatch.setattr(runtime, "_LOCAL_RANK", 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", picked.append)
    assert dev_mod.resolve_device("cuda") == torch.device("cuda", 1)
    assert picked == [torch.device("cuda", 1)]
    assert dev_mod.resolve_device("cuda:0") == torch.device("cuda", 0)  # explicit stays
    assert dev_mod.resolve_device("cpu") == torch.device("cpu")


def test_main_process_gates_saver_and_logger(tmp_path, monkeypatch):
    import argparse

    from devit_tpu_torch.cli import common as C
    from devit_tpu_torch.train.meters import create_logger

    name = f"devit_test_{os.getpid()}"
    monkeypatch.setattr(runtime, "rank", lambda: 1)
    assert not runtime.is_main_process()
    C.make_saver(argparse.Namespace(ckpt_format="msgpack"))(str(tmp_path / "c.msgpack"),
                                                             {"a": np.zeros(2)})
    log = create_logger(str(tmp_path), name=name)
    log.info("from rank 1")
    for h in log.handlers:
        h.flush()
    assert not (tmp_path / "c.msgpack").exists() and not (tmp_path / "log.txt").exists()
    assert "from rank 1" in (tmp_path / "log_rank1.txt").read_text()
    assert not any(type(h) is logging.StreamHandler for h in log.handlers)  # no console
    monkeypatch.setattr(runtime, "rank", lambda: 0)
    C.make_saver(argparse.Namespace(ckpt_format="msgpack"))(str(tmp_path / "c.msgpack"),
                                                             {"a": np.zeros(2)})
    log0 = create_logger(str(tmp_path / "r0"), name=name + "_0")
    assert (tmp_path / "c.msgpack").exists()
    assert any(type(h) is logging.StreamHandler for h in log0.handlers)
    for lg in (log, log0):
        for h in list(lg.handlers):
            lg.removeHandler(h)
            h.close()


def test_a_failing_rank_stops_the_launch_without_hanging():
    """Rank 1 raises before the first collective that rank 0 waits in: the
    launcher stops every rank and reports rank 1's error (rank 0's own
    failure, its peer gone, beside it)."""
    with pytest.raises(RankFailure, match="(?s)rank 1 exited.*rank 1 fails on purpose"):
        run_ranks(f"{WORKER}:fail_on_rank_one", 2, timeout=120)


def test_a_launch_past_its_timeout_is_killed():
    import time

    t0 = time.monotonic()
    with pytest.raises(RankFailure, match="outlived their 8 s timeout"):
        run_ranks(f"{WORKER}:sleep_past_the_timeout", 2, timeout=8)
    assert time.monotonic() - t0 < 60


def test_real_two_process_rendezvous():
    """A genuine gloo group of two OS processes (tests/test_runtime.py's
    rendezvous for the JAX package): the stage-2 step's loss and eval
    counters and the stage-5 step's loss, with the division axis spanning
    both processes, equal the one-process run of the same inputs."""
    specs = W.small_specs()
    par = run_ranks(f"{WORKER}:rendezvous", 2, args=(specs,), timeout=240)
    one = W.rendezvous(specs, parallel=False)
    assert par[0]["world"] == par[1]["world"] == 2
    for r in par:
        for k, v in one.items():
            if k != "world":
                np.testing.assert_allclose(r[k], v, rtol=1e-5, err_msg=k)
