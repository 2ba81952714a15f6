"""The input generators: a pool is the seed's alone, seeds give frames of
one kind, and the photo-like frames are smooth, with edges."""

import json

import pytest
import torch

from port_bench import core

BENCH = core.Bench()
CPU = torch.device("cpu")
MIXES = sorted(p.stem for p in (BENCH.dir / "traffic").glob("*.json"))


def pool(traffic, seed, **sizes):
    traffic = dict(traffic, **sizes)
    generator = torch.Generator(device=CPU)
    generator.manual_seed(seed)
    return BENCH.load("inputs", traffic["input"]).make_pool(traffic, generator, CPU)


def mix(name):
    return json.loads((BENCH.dir / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIXES)
def test_a_pool_is_the_seeds_alone(name):
    small = {"height": 40, "width": 56, "pool_frames": 3}
    a, b, c = (pool(mix(name), seed, **small) for seed in (2 ** 31 + 3, 2 ** 31 + 3, 4))
    assert a.shape == (3, 40, 56, 3) and a.dtype == torch.uint8
    assert torch.equal(a, b) and not torch.equal(a, c)
    # every frame of the pool differs from the others
    assert len({f.numpy().tobytes() for f in a}) == 3


@pytest.mark.parametrize("name", MIXES)
def test_seeds_give_frames_of_the_same_kind(name):
    """The mean step between neighbours, which sets the range weights'
    spread, agrees from seed to seed: a seed changes the frames, not the
    work."""
    steps = [neighbour_step(pool(mix(name), seed, height=128, width=192, pool_frames=4))
             for seed in (1, 2 ** 31 + 7, 2 ** 40 + 1, 99)]
    assert max(steps) < 1.1 * min(steps)


def neighbour_step(frames):
    return (frames[:, :, 1:].float() - frames[:, :, :-1].float()).abs().mean().item()


@pytest.mark.parametrize("name", [m for m in MIXES if mix(m)["input"] == "u8_photo_like"])
def test_photo_like_frames_are_smooth_with_edges(name):
    frames = pool(mix(name), 11, height=256, width=384, pool_frames=2)
    step = neighbour_step(frames)
    assert 1.5 < step < 6.0  # a photograph's mean step between neighbours: a few levels
    jumps = (frames[:, :, 1:].float() - frames[:, :, :-1].float()).abs().amax(-1)
    assert (jumps > 30).float().mean() > 1e-3  # edges: a few steps of tens of levels
    assert frames.float().std() > 30  # the full range in use, not a flat field
