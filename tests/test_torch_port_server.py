"""The port's serving front end on the CPU with a tiny pipeline: batching,
padding of a ragged batch, and determinism per (seed, batch index)."""
import io
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch
import yaml

from dsml_thesis_tpu_torch.config import build_model
from dsml_thesis_tpu_torch.diffusion import (make_ddim_schedule,
                                             make_video_pipeline)
from dsml_thesis_tpu_torch.server import (BadRequest, MicroBatcher, Overloaded,
                                          PipelineServer, batch_seed,
                                          make_pipeline_runner)
from test_ldm import TINY_MEAD_CFG
from test_torch_port_hygiene import one_torch_thread  # noqa: F401

F, WINDOW, BATCH = 2, 2, 4
SHAPES = {"masked_frames": (F, 16, 16, 3), "audio": (F + WINDOW, 32),
          "identity": (16, 16, 3), "class_label": ()}


@pytest.fixture(scope="module")
def pipeline():
    torch.manual_seed(0)
    ldm = build_model(yaml.safe_load(TINY_MEAD_CFG)["model"]).eval()
    ddim = make_ddim_schedule(ldm.schedule, 2, eta=0.0)
    return make_video_pipeline(ldm, ddim, WINDOW, guidance_scale=2.0)


def _request(i):
    rng = np.random.default_rng(i)
    return {
        "masked_frames": rng.uniform(-1, 1, SHAPES["masked_frames"]
                                     ).astype(np.float32),
        "audio": rng.standard_normal(SHAPES["audio"]).astype(np.float32),
        "identity": rng.uniform(-1, 1, SHAPES["identity"]).astype(np.float32),
        "class_label": np.int32(i % 8),
    }


def _stack(reqs):
    return {k: np.stack([r[k] for r in reqs]) for k in reqs[0]}


def test_runner_is_deterministic_per_seed_and_index(pipeline):
    stacked = _stack([_request(i) for i in range(BATCH)])
    run = make_pipeline_runner(pipeline, seed=3, device="cpu")
    a, b = run(stacked, 0), run(stacked, 0)
    assert a.shape == (BATCH, F, 16, 16, 3) and a.dtype == np.float32
    assert np.abs(a).max() <= 1.0
    assert np.array_equal(a, b)
    assert not np.array_equal(a, run(stacked, 1))
    other = make_pipeline_runner(pipeline, seed=4, device="cpu")
    assert not np.array_equal(a, other(stacked, 0))
    again = make_pipeline_runner(pipeline, seed=3, device="cpu")
    assert np.array_equal(a, again(stacked, 0))


def test_batch_seed_separates_neighbours():
    seeds = {batch_seed(s, i) for s in range(8) for i in range(64)}
    assert len(seeds) == 8 * 64
    assert all(0 <= s < 1 << 63 for s in seeds)


def test_ragged_batch_is_padded_and_rows_answer_their_requests(pipeline):
    """3 requests into a tier of 4: the runner sees 4 rows, the last one
    repeated; each client gets the row of its own request."""
    seen = []
    run = make_pipeline_runner(pipeline, seed=0, device="cpu")

    def run_batch(stacked, batch_index):
        seen.append((batch_index, {k: v.copy() for k, v in stacked.items()}))
        return run(stacked, batch_index)

    batcher = MicroBatcher(run_batch, BATCH, max_wait_ms=500.0)
    reqs = [_request(i) for i in range(3)]
    results = [None] * 3

    def client(i):
        results[i] = batcher.submit(reqs[i], timeout=120)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stats = batcher.stats()
    batcher.shutdown()
    assert len(seen) == 1 and seen[0][0] == 0
    stacked = seen[0][1]
    assert stacked["masked_frames"].shape == (BATCH,) + SHAPES["masked_frames"]
    np.testing.assert_array_equal(stacked["identity"][3],
                                  stacked["identity"][2])
    assert stats["requests"] == 3 and stats["batches"] == 1
    assert stats["mean_occupancy"] == 0.75
    # offline reproduction from (seed, batch index, inputs)
    want = run(stacked, 0)
    for i, r in enumerate(reqs):
        row = next(j for j in range(3) if np.array_equal(
            stacked["identity"][j], r["identity"]))
        assert results[i].shape == (F, 16, 16, 3)
        np.testing.assert_array_equal(results[i], want[row])


def test_second_batch_gets_the_next_index():
    calls = []

    def run_batch(stacked, batch_index):
        calls.append(batch_index)
        return np.full((2, 1), batch_index, np.float32)

    batcher = MicroBatcher(run_batch, 2, max_wait_ms=10.0)
    outs = [batcher.submit({"x": np.zeros(1)}, timeout=30) for _ in range(3)]
    batcher.shutdown()
    assert calls == [0, 1, 2]
    assert [float(o[0]) for o in outs] == [0.0, 1.0, 2.0]


def test_load_shedding_and_shutdown():
    gate = threading.Event()

    def run_batch(stacked, batch_index):
        gate.wait(30)
        return np.zeros((1, 1), np.float32)

    batcher = MicroBatcher(run_batch, 1, max_wait_ms=1.0, max_queue=0)
    with pytest.raises(Overloaded):
        batcher.submit({"x": np.zeros(1)}, timeout=5)
    gate.set()
    batcher.shutdown()
    with pytest.raises(RuntimeError):
        batcher.submit({"x": np.zeros(1)}, timeout=5)
    with pytest.raises(ValueError):
        MicroBatcher(run_batch, 0)


def test_http_round_trip_and_bad_request(pipeline):
    run = make_pipeline_runner(pipeline, seed=0, device="cpu")
    server = PipelineServer(MicroBatcher(run, BATCH, max_wait_ms=20.0), SHAPES)
    port = server.start(port=0)
    try:
        buf = io.BytesIO()
        np.savez(buf, **_request(0))
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/synthesize", data=buf.getvalue(),
            method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            frames = np.load(io.BytesIO(resp.read()))["frames"]
        assert frames.shape == (F, 16, 16, 3)
        assert np.isfinite(frames).all() and np.abs(frames).max() <= 1.0
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["status"] == "ok" and health["batch_size"] == BATCH
        bad = _request(1)
        bad["identity"] = bad["identity"][:8]
        with pytest.raises(BadRequest):
            server._validate(bad)
    finally:
        server.stop()
    with pytest.raises(ValueError):
        PipelineServer(MicroBatcher(run, 1), {"audio": (1, 1)})
