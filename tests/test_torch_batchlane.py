"""The port's batch lane (``pio_tpu_torch/server/batchlane.py``) against
the JAX package's, on the CPU, with ``threading.Event`` doorbells.

- ``pack_query_i8`` gives the reference's bytes, and both packages
  unpack and check each other's frames alike;
- a segment one package creates has the other's bytes, and the other
  opens and serves it (the port's client, the reference's drainer, and
  the other way round);
- the reference's lane cases (``tests/test_batch_buckets.py``) on the
  port: the round trip that aggregates two workers into one batch, the
  drainer thread, an oversize body, a full stripe, a timed-out slot
  reclaimed once answered, a remote error, and an undecodable request
  failing only its slot. Every wait has a deadline.
"""

import struct
import threading

import numpy as np
import pytest

from pio_tpu.obs import monotonic_s
from pio_tpu.server import batchlane as ref
from pio_tpu_torch.server import batchlane as port

#: a response wait, a thread join and a depth poll, seconds
WAIT_S = 5.0


def lane(mod, tmp_path, n_workers=2, name="lane.shm", **kw):
    seg = mod.BatchLaneSegment.create(str(tmp_path / name), n_workers, **kw)
    return seg, threading.Event(), [threading.Event()
                                    for _ in range(n_workers)]


def wait_depth(seg, n):
    deadline = monotonic_s() + WAIT_S
    while seg.pending_depth() < n and monotonic_s() < deadline:
        threading.Event().wait(0.002)
    return seg.pending_depth()


@pytest.mark.parametrize("codes", [
    [], [0], [1, -2, 3], [127, -127, 0, 5] * 64,
    np.random.default_rng(0).integers(-127, 128, 256),
], ids=["empty", "one", "three", "256-pattern", "256-random"])
def test_packed_frames_equal_the_reference(codes):
    frame = port.pack_query_i8(codes)
    assert frame == ref.pack_query_i8(codes)
    assert port.packed_frame_ok(frame) and ref.packed_frame_ok(frame)
    np.testing.assert_array_equal(port.unpack_query_i8(frame).codes,
                                  ref.unpack_query_i8(frame).codes)
    for bad in (frame[:-1] if len(codes) else frame[:3], b"\x01" + frame[1:],
                frame + b"\x00"):
        assert port.packed_frame_ok(bad) == ref.packed_frame_ok(bad)
        assert not port.packed_frame_ok(bad)
        with pytest.raises((ValueError, struct.error)):
            port.unpack_query_i8(bad)


def test_segments_have_the_same_bytes(tmp_path):
    a, _, _ = lane(port, tmp_path, 3, "a.shm", slots_per_worker=4,
                   payload_bytes=128)
    b, _, _ = lane(ref, tmp_path, 3, "b.shm", slots_per_worker=4,
                   payload_bytes=128)
    try:
        assert (tmp_path / "a.shm").read_bytes() == \
            (tmp_path / "b.shm").read_bytes()
        for seg in (a, b):
            seg.post_request(1, 2, b'{"q": 1}')
            seg.post_response(1, 2, 1, b'{"a": 2}')
        assert (tmp_path / "a.shm").read_bytes() == \
            (tmp_path / "b.shm").read_bytes()
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("creator, server", [(port, ref), (ref, port)],
                         ids=["port-creates", "reference-creates"])
def test_one_package_creates_the_other_serves(tmp_path, creator, server):
    seg, doorbell, resp = lane(creator, tmp_path)
    other = server.BatchLaneSegment.open(seg.path)
    client_mod = creator
    drainer = server.LaneDrainer(
        other, lambda bodies: [
            {"n": len(b)} if isinstance(b, server.PackedQuery)
            else {"echo": b["q"]} for b in bodies],
        doorbell, resp, poll_s=0.01).start()
    try:
        client = client_mod.LaneClient(seg, 1, doorbell, resp[1],
                                       timeout_s=WAIT_S)
        assert client.submit({"q": 7}) == {"echo": 7}
        packed = client_mod.pack_query_i8([1, 2, 3])
        assert client.submit({}, packed=packed) == {"n": 3}
        assert client.submit_packed(packed) == b'{"n": 3}'
    finally:
        drainer.stop()
        other.close()
        seg.close()
    assert drainer.drained == 3


def test_open_rejects_garbage(tmp_path):
    p = tmp_path / "junk.shm"
    p.write_bytes(b"NOTALANE" + b"\0" * 64)
    with pytest.raises(ValueError):
        port.BatchLaneSegment.open(str(p))


def test_roundtrip_aggregates_across_workers(tmp_path):
    seg, doorbell, resp = lane(port, tmp_path, n_workers=3)
    batches = []

    def dispatch(bodies):
        batches.append(len(bodies))
        return [{"echo": b["user"]} for b in bodies]

    drainer = port.LaneDrainer(seg, dispatch, doorbell, resp)
    clients = [port.LaneClient(seg, w, doorbell, resp[w], timeout_s=WAIT_S)
               for w in (1, 2)]
    out = {}

    def submit(w):
        out[w] = clients[w - 1].submit({"user": f"u{w}"})

    threads = [threading.Thread(target=submit, args=(w,), daemon=True)
               for w in (1, 2)]
    for t in threads:
        t.start()
    assert wait_depth(seg, 2) == 2
    assert drainer.drain_once() == 2  # both workers in ONE batch
    for t in threads:
        t.join(WAIT_S)
    assert out == {1: {"echo": "u1"}, 2: {"echo": "u2"}}
    assert batches == [2] and seg.pending_depth() == 0


def test_drainer_thread_serves(tmp_path):
    seg, doorbell, resp = lane(port, tmp_path)
    drainer = port.LaneDrainer(
        seg, lambda bodies: [{"n": len(bodies)} for _ in bodies],
        doorbell, resp, poll_s=0.01).start()
    try:
        client = port.LaneClient(seg, 1, doorbell, resp[1], timeout_s=WAIT_S)
        assert client.submit({"q": 1}) == {"n": 1}
        assert client.submit({"q": 2}) == {"n": 1}
    finally:
        drainer.stop()
    assert drainer.drained == 2 and drainer.cycles == 2


def test_oversize_body_falls_back(tmp_path):
    seg, doorbell, resp = lane(port, tmp_path, payload_bytes=64)
    client = port.LaneClient(seg, 0, doorbell, resp[0], timeout_s=0.2)
    with pytest.raises(port.LaneFallback) as ei:
        client.submit({"blob": "x" * 200})
    assert ei.value.reason == "oversize"


def test_full_stripe_falls_back(tmp_path):
    seg, doorbell, resp = lane(port, tmp_path, slots_per_worker=2)
    client = port.LaneClient(seg, 0, doorbell, resp[0], timeout_s=0.05)
    # no drainer: both slots stay in flight (timeout), the third is full
    for _ in range(2):
        with pytest.raises(port.LaneFallback) as ei:
            client.submit({"q": 1})
        assert ei.value.reason == "timeout"
    with pytest.raises(port.LaneFallback) as ei:
        client.submit({"q": 1})
    assert ei.value.reason == "full"


def test_timed_out_slot_reclaimed_after_answer(tmp_path):
    seg, doorbell, resp = lane(port, tmp_path, slots_per_worker=1)
    client = port.LaneClient(seg, 0, doorbell, resp[0], timeout_s=0.05)
    with pytest.raises(port.LaneFallback):
        client.submit({"q": "zombie"})
    drainer = port.LaneDrainer(
        seg, lambda bodies: [{"late": True}] * len(bodies), doorbell, resp)
    assert drainer.drain_once() == 1  # a late answer to the abandoned slot
    drainer.start()
    try:
        assert client.submit({"q": "fresh"}, timeout_s=WAIT_S) == \
            {"late": True}
    finally:
        drainer.stop()


def test_dispatch_error_reports_remote_error(tmp_path):
    seg, doorbell, resp = lane(port, tmp_path)

    def boom(bodies):
        raise RuntimeError("model died")

    drainer = port.LaneDrainer(seg, boom, doorbell, resp, poll_s=0.01).start()
    try:
        client = port.LaneClient(seg, 1, doorbell, resp[1], timeout_s=WAIT_S)
        with pytest.raises(port.LaneFallback) as ei:
            client.submit({"q": 1})
        assert ei.value.reason == "remote_error"
    finally:
        drainer.stop()


def test_undecodable_request_errors_only_that_slot(tmp_path):
    seg, doorbell, resp = lane(port, tmp_path)
    seg.post_request(0, 0, b"\xff\xfenot json")
    seg.post_request(1, 0, b'{"q": 1}')
    drainer = port.LaneDrainer(
        seg, lambda bodies: [{"ok": True}] * len(bodies), doorbell, resp)
    assert drainer.drain_once() == 1  # only the decodable one dispatched
    assert seg.read_response(0, 0, 1)[0] == port.STATUS_ERROR
    assert seg.read_response(1, 0, 1) == (port.STATUS_OK, b'{"ok": true}')


def test_answered_slot_stays_with_its_submitter(tmp_path):
    """A slot answered but not yet read by its (live) submitter is not
    handed to another request: the reference's allocator steals it as a
    timed-out one, so the new request overwrites the unread answer (an
    empty or foreign body under 16 concurrent clients); the port
    reclaims only slots whose submitter timed out."""
    for mod, stolen in ((port, None), (ref, 0)):
        seg, doorbell, resp = lane(mod, tmp_path, slots_per_worker=1,
                                   name=f"{mod.__name__}.shm")
        client = mod.LaneClient(seg, 0, doorbell, resp[0], timeout_s=WAIT_S)
        slot = client._acquire_slot()
        seq = seg.post_request(0, slot, b'{"q": 1}')
        seg.post_response(0, slot, seq, b'{"a": 1}')
        assert client._acquire_slot() == stolen, mod.__name__
        seg.close()


@pytest.mark.cuda
def test_lane_served_on_the_card_equals_the_cpu(tmp_path):
    """Packed int8 frames through the lane to a resident scorer on the
    card answer the codes of its CPU twin."""
    import torch

    from pio_tpu_torch.server.residency import ResidentLinearScorer

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(0)
    W = rng.standard_normal((8, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    s = rng.uniform(0.01, 0.1, 8).astype(np.float32)
    card, cpu = (ResidentLinearScorer(W, b, scales=s, device=d)
                 for d in ("cuda", "cpu"))
    seg, doorbell, resp = lane(port, tmp_path)
    drainer = port.LaneDrainer(seg, lambda bodies: [int(c) for c in (
        card.score_wire(np.stack([q.codes for q in bodies])))],
        doorbell, resp, poll_s=0.01).start()
    try:
        client = port.LaneClient(seg, 1, doorbell, resp[1], timeout_s=WAIT_S)
        X = rng.standard_normal((32, 8)).astype(np.float32)
        codes = cpu.quantize(X)
        got = [client.submit({}, packed=port.pack_query_i8(c)) for c in codes]
    finally:
        drainer.stop()
    assert got == [int(c) for c in cpu.score_wire(codes)]
