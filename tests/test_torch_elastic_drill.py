"""The elastic drills of ``chip_smoke.py``'s ``dist_elastic`` phase on
the CPU, at a small size: BERT pretraining (2 layers, hidden 32) under
fleet with ZeRO-2 in f32, four gloo ranks started by the port's launcher
with the lease plane armed, sharded checkpoints every 2 steps.

* (a) trainer1 is killed (``crash:ckpt_shard_committed:2``) between its
  shard commit and the global commit of step 4; under --elastic_retries
  1 the relaunch restores step 2, never the torn step 4, and its losses
  for steps 3-4 and its step-4 checkpoint equal the clean run's bit for
  bit.
* (b) trainer3 is lost for good at the start of step 5; the coordinator
  evicts it, the launcher restarts three ranks with
  PADDLE_ELASTIC_RESHARD=1 at membership epoch 1, ZeRO's moments split
  again for dp 3, and steps 5-6 and the step-6 checkpoint equal bit for
  bit a clean dp-3 launch restored from the same checkpoint.

The phase holds all of that itself (its ``fail`` raises here); the
tests read its report.  As on the card, (a) runs beside the clean run
and (b) beside its reference and (a)'s relaunch, each launcher and its
ranks with a deadline.
"""
from __future__ import annotations

import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

TINY = dict(device="cpu", bf16=False, batch=12, seq=32, max_preds=4,
            lease_secs=10.0, join_s=150,
            bert=dict(num_hidden_layers=2, hidden_size=32,
                      num_attention_heads=2, intermediate_size=64,
                      vocab_size=128, max_position_embeddings=64))


class PhaseFailed(AssertionError):
    pass


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    def fail(msg):
        raise PhaseFailed(msg)

    real = chip_smoke.fail
    chip_smoke.fail = fail
    # the ranks are tiny: one thread each keeps twelve of them off each
    # other's cores
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        yield chip_smoke.phase_dist_elastic(
            torch, "cpu", str(tmp_path_factory.mktemp("elastic")), c=TINY)
    finally:
        chip_smoke.fail = real
        if threads is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = threads


def test_clean_run_commits_steps_2_and_4(report):
    assert sorted(report["clean_losses"]) == [1, 2, 3, 4]
    costs = report["costs"]["clean"]["attempts"]
    assert len(costs) == 1 and costs[0]["world"] == 4
    assert costs[0]["shard_bytes"] and costs[0]["shard_bytes"][0] > 0


def test_drill_a_relaunch_is_bit_exact(report):
    a = report["a"]
    assert a["committed_at_relaunch"] == [2]
    assert a["torn_step_shards"] == ["rank0", "rank1", "rank2", "rank3"]
    assert a["relaunch_losses"] == {3: report["clean_losses"][3],
                                    4: report["clean_losses"][4]}
    assert a["state"]["adam_moments"] > 0
    assert a["state"]["vars_bit_equal"] >= a["state"]["adam_moments"]
    assert a["detect_to_respawn_s"] >= 0
    assert [att["restored_step"] for att in
            report["costs"]["a"]["attempts"]] == [0, 2]


def test_drill_b_resize_is_bit_exact(report):
    b = report["b"]
    assert sorted(b["losses"]) == [5, 6]
    assert b["losses"] == b["dp3_reference"]
    assert b["state"]["adam_moments"] > 0
    worlds = [att["world"] for att in report["costs"]["b"]["attempts"]]
    assert worlds == [4, 3]
    assert [att["restored_step"] for att in
            report["costs"]["b"]["attempts"]] == [4, 4]


def test_lease_renewals_reached_the_coordinator(report):
    lease = report["costs"]["b3"]["attempts"][0]["lease"]
    assert sorted(lease) == ["trainer0", "trainer1", "trainer2"]
    for m in lease.values():
        assert m["lease_secs"] == TINY["lease_secs"]
        assert m["renewals"] >= 2
        assert 0 < m["max_gap_s"] < m["expiry_s"]


def test_each_attempt_names_the_jobs_beside_it(report):
    costs = report["costs"]
    assert "a" in costs["clean"]["attempts"][0]["concurrent_with"]
    assert "b" in costs["b3"]["attempts"][0]["concurrent_with"]
    for job, c in costs.items():
        for att in c["attempts"]:
            assert job not in att["concurrent_with"]
