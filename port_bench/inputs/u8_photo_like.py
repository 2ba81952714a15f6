"""Photo-like u8 frames, made on the device from the seed: a field that is
smooth at several scales (each octave's amplitude in proportion to its size,
as a photograph's spectrum falls as 1/f), regions with sharp curved edges
laid over it, and mild sensor noise.  The traffic mix gives:

    octaves_px    the feature sizes of the smooth field, in pixels
    contrast      the largest octave's amplitude, in u8 levels
    edge_px       the feature size of the regions' boundaries, in pixels
    edge_layers   independent region maps laid over each other
    edge_step     the largest step, per channel, that a region map adds at its edges
    noise_sigma   the sensor noise's standard deviation, in u8 levels

Every seed draws the same numbers of values in the same shapes."""

import math

import torch
import torch.nn.functional as F

CHUNK_PIXELS = 1 << 23  # pixels made at once: bounds the float temporaries


def _field(frames: int, channels: int, height: int, width: int, size_px: int,
           generator: torch.Generator, device: torch.device, mode: str) -> torch.Tensor:
    """(frames, channels, height, width) float32, uniform -1..1 on a grid of
    ``size_px`` pixels, interpolated between its points."""
    grid = (math.ceil(height / size_px) + 1, math.ceil(width / size_px) + 1)
    coarse = torch.rand((frames, channels, *grid), generator=generator, device=device)
    return F.interpolate(coarse * 2 - 1, size=(height, width), mode=mode, align_corners=False)


def make_pool(traffic: dict, generator: torch.Generator, device: torch.device) -> torch.Tensor:
    """(pool_frames, height, width, channels) uint8."""
    n, h, w, c = (traffic["pool_frames"], traffic["height"], traffic["width"],
                  traffic["channels"])
    octaves = traffic["octaves_px"]
    pool = torch.empty((n, h, w, c), dtype=torch.uint8, device=device)
    step = max(1, CHUNK_PIXELS // (h * w))
    for first in range(0, n, step):
        b = min(step, n - first)
        img = torch.full((b, c, h, w), 127.5, device=device)
        for size in octaves:
            amplitude = traffic["contrast"] * size / max(octaves)
            img += amplitude * _field(b, c, h, w, size, generator, device, "bicubic")
        for _ in range(traffic["edge_layers"]):
            region = _field(b, 1, h, w, traffic["edge_px"], generator, device, "bilinear") > 0
            shift = torch.rand((b, c, 1, 1), generator=generator, device=device) * 2 - 1
            img += region * (shift * traffic["edge_step"])
        img += torch.randn((b, c, h, w), generator=generator, device=device) * traffic[
            "noise_sigma"]
        pool[first:first + b] = img.round_().clamp_(0, 255).permute(0, 2, 3, 1).to(torch.uint8)
    return pool
