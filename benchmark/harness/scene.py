"""A configuration's scene, made on the device from the run's seed by the
generator that ``reference/scenes/<scene>.py`` holds."""

from __future__ import annotations

import importlib

import torch


def generator(seed: int, dev: torch.device) -> torch.Generator:
    """The device's default generator, seeded with ``seed`` (any whole
    number from 0 to 2**64 - 1). The default one, so that draws which take
    no generator argument (``torch._standard_gamma``) follow the seed too."""
    if dev.type == "cuda":
        torch.cuda.init()
        gen = torch.cuda.default_generators[dev.index or 0]
    else:
        gen = torch.default_generator
    gen.manual_seed(seed % (1 << 64))
    return gen


def make_cloud(config: dict, seed: int, dev: torch.device) -> dict:
    """The scene's (N, .) float32 tensors on ``dev``: means, scales, quats,
    opacities, colors."""
    mod = importlib.import_module(f"reference.scenes.{config['scene']}")
    cloud = mod.make(config["scene_params"], generator(seed, dev), dev)
    return {k: v.contiguous() for k, v in cloud.items()}
