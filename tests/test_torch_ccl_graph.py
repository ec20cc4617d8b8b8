"""The cleanup's CUDA graph on a card: ``ccl.clean_masks_batched``
replaying the graph of its body against the body run launch by launch
(``ccl._clean_masks_eager``), bit for bit in the cleaned masks and the
overflow bits, at the rig's image size.

Every test here is marked ``card`` and skips without a CUDA device.  The
file imports no JAX; on a card's host, where JAX is absent, run it without
the suite's ``conftest.py``::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ccl_graph.py

``chip_smoke.py`` runs it so in its phase 25.
"""

import os
import sys

import numpy as np
import pytest
import torch

from vbr_tpu_torch.ops import ccl
from vbr_tpu_torch.ops.ccl_label import K2
from vbr_tpu_torch.utils import profiling
from vbr_tpu_torch.utils.config import DEFAULT_MASK_PARAMS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RIG_HW = (486, 644)
CAPS = dict(kf=512, kb=128, k_runs=64, max_iters=64)  # the defaults
RIG_FRAMES = (0, 1, 2, 3, 4, 5, 6, 7, 107, 321)  # 107, 321: the bursts


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cleanup's graph runs on a card")
    return torch.device("cuda")


def thresholds(B):
    """The rig's per-camera (figure, inner) thresholds for B images."""
    ps = [DEFAULT_MASK_PARAMS[b % 4] for b in range(B)]
    return (tuple(float(p.figure_threshold) for p in ps),
            tuple(float(p.inner_threshold) for p in ps))


def raw_masks(seed, B, H=RIG_HW[0], W=RIG_HW[1]):
    """(B, H, W) u8 {0, 255}: a figure with holes and speckle; every fourth
    image (b % 4 == 3) a grid of single pixels, past K2's 512 components."""
    rng = np.random.default_rng(seed)
    out = np.zeros((B, H, W), np.uint8)
    for b in range(B):
        m = out[b]
        if b % 4 == 3:
            m[::3, ::3] = 255
            continue
        y, x = rng.integers(60, H - 200), rng.integers(60, W - 200)
        m[y:y + 160, x:x + 110] = 255
        m[y + 40:y + 70, x + 30:x + 60] = 0  # a large hole
        m[y + 100:y + 103, x + 20:x + 23] = 0  # a small one
        sy, sx = rng.integers(0, H, 200), rng.integers(0, W, 200)
        m[sy, sx] = 255
    return out


def eager(raw, fig, inner):
    return ccl._clean_masks_eager(raw, fig, inner, CAPS["kf"], CAPS["kb"],
                                  CAPS["k_runs"], CAPS["max_iters"])


def assert_graph_equals_eager(raw, fig, inner):
    """One call through the graph against the eager body; returns the
    overflow bits."""
    replays = profiling.counters().get("cleanup_graph_replays", 0)
    got = ccl.clean_masks_batched(raw, fig, inner)
    want = eager(raw, fig, inner)
    torch.cuda.synchronize()
    assert profiling.counters()["cleanup_graph_replays"] == replays + 1
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    return got[1].cpu()


@pytest.mark.card
@pytest.mark.parametrize("B", [1, 4, 32])
def test_graph_equals_eager(card, B):
    """B = 1 (a sharded rank's image), 4 (a live frame), 32 (an offline
    chunk of 8 frames): the capture's call and two replays on new masks."""
    fig, inner = thresholds(B)
    for seed in range(3):
        raw = torch.from_numpy(raw_masks(seed, B)).to(card)
        ovf = assert_graph_equals_eager(raw, fig, inner)
        assert ovf.tolist() == [b % 4 == 3 for b in range(B)]


@pytest.mark.card
def test_graph_equals_eager_on_the_rig_frames(card):
    """The benchmark's seeded rig (``rig128x4``, traffic ``live46``): the
    raw masks of frames 0-7 and of the burst frames 107 and 321, which
    overflow in both, one frame per call; then the offline chunk of frames
    104-111 as one call of 32 images."""
    sys.path.insert(0, ROOT)
    try:
        from benchmark import program, rigdata, spec
    finally:
        sys.path.remove(ROOT)
    bench = spec.load_benchmark(ROOT)
    config = spec.config(ROOT, bench, "rig128x4")
    traffic = spec.traffic(ROOT, "live46")
    inputs = rigdata.make(ROOT, config, traffic, 2147483711, card)
    model = program.build(config, inputs, card)
    model._ensure_fast_state()
    stage = model._stage
    fig, inner = stage.fig_thresholds, stage.inner_thresholds

    def raw(t):
        return stage.head(torch.from_numpy(inputs.video[t]).to(card))[0]

    for t in RIG_FRAMES:
        ovf = assert_graph_equals_eager(raw(t), fig, inner)
        assert bool(ovf.any()) == rigdata.is_burst(traffic, t), t
    chunk = torch.cat([raw(t) for t in range(104, 112)])
    ovf = assert_graph_equals_eager(chunk, fig * 8, inner * 8)
    assert ovf.reshape(8, 4).any(dim=1).tolist() == [
        rigdata.is_burst(traffic, t) for t in range(104, 112)]


@pytest.mark.card
def test_replays_return_fresh_tensors(card):
    """The outputs of a call are its own: the next replay, which rewrites
    the graph's static buffers, leaves them as they were."""
    fig, inner = thresholds(4)
    raw1 = torch.from_numpy(raw_masks(10, 4)).to(card)
    raw2 = torch.from_numpy(raw_masks(11, 4)).to(card)
    first = ccl.clean_masks_batched(raw1, fig, inner)
    kept = [x.clone() for x in first]
    second = ccl.clean_masks_batched(raw2, fig, inner)
    torch.cuda.synchronize()
    for a, b, k in zip(first, second, kept):
        assert a.data_ptr() != b.data_ptr()
        assert torch.equal(a, k)
    assert not torch.equal(first[0], second[0])
    assert torch.equal(second[0], eager(raw2, fig, inner)[0])


@pytest.mark.card
def test_replays_on_a_side_stream(card):
    """Calls alternate between a side stream and the default one; each
    equals the eager body."""
    fig, inner = thresholds(4)
    side = torch.cuda.Stream()
    outs = []
    for i in range(4):
        raw = torch.from_numpy(raw_masks(20 + i, 4)).to(card)
        if i % 2:
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                got = ccl.clean_masks_batched(raw, fig, inner)
            torch.cuda.current_stream().wait_stream(side)
            for x in got:
                x.record_stream(torch.cuda.current_stream())
        else:
            got = ccl.clean_masks_batched(raw, fig, inner)
        outs.append((raw, got))
    for raw, got in outs:
        want = eager(raw, fig, inner)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.card
def test_counts_per_call(card):
    """A new key captures once; every call replays once and counts one K2
    launch, the capture's call included."""
    fig = (1234.0, 2345.0, 3456.0)  # thresholds of no other test: a new key
    inner = (11.0, 22.0, 33.0)
    raw = torch.from_numpy(raw_masks(30, 3)).to(card)

    def counts():
        c = profiling.counters()
        return (c.get("cleanup_graph_captures", 0),
                c.get("cleanup_graph_replays", 0), K2.launches)

    c0 = counts()
    ccl.clean_masks_batched(raw, fig, inner)
    c1 = counts()
    assert [b - a for a, b in zip(c0, c1)] == [1, 1, 1]
    for _ in range(3):
        ccl.clean_masks_batched(raw, fig, inner)
    c2 = counts()
    assert [b - a for a, b in zip(c1, c2)] == [0, 3, 3]
