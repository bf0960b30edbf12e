"""What every sampler's job shares: the target's density and starting
points made from the configuration and the seed, and the ESS check at the
end. A job gives the sampler the target's latent dict
(``ctx["target"].latents``) and reads its draws, positions and mass back
flat (``ctx["target"].flat``), ``[..., chains, dim]``."""

from __future__ import annotations

import torch

from benchmark.harness import job_key, job_words


def build(ctx, sampler: str):
    """Put the target's density, the program's built-in made from the
    configuration on the device, and the cell's sampler
    (``zhusuan_tpu_torch.<sampler>(**args)``) into ``ctx``."""
    import zhusuan_tpu_torch

    ctx["density"] = ctx["target"].density(ctx["config"], ctx["device"])
    ctx["sampler"] = getattr(zhusuan_tpu_torch, sampler)(**ctx["cell"]["args"])


def release(ctx):
    """Drop the sampler and the density: the program's state is freed
    before the reference runs."""
    ctx.pop("sampler", None)
    ctx.pop("density", None)


def start(ctx, index: int):
    """``(key, q0)``: the job's Philox key and its starting points, drawn
    on the card from ``(seed, job)``: ``init_std`` times standard normals,
    float32 ``[chains, dim]``."""
    cell, dev = ctx["cell"], ctx["device"]
    g = torch.Generator(device=dev)
    g.manual_seed(job_words(ctx["seed"], index) >> 1)
    q0 = torch.randn((cell["chains"], ctx["plain"].dim(ctx["config"])),
                     generator=g, device=dev)
    q0.mul_(cell["init_std"])
    return job_key(ctx["seed"], index), q0


def ess_stage(ctx, spans, draws):
    """The check users run on the sampling draws: the program's
    ``ess_batch_device`` over every chain and dimension; the job's ESS is
    the per-chain minimum over dimensions, summed over chains, read on the
    host."""
    from zhusuan_tpu_torch.diagnostics import ess_batch_device

    with spans.stage("ess"):
        n, c, d = draws.shape
        ess = ess_batch_device(draws.reshape(n, c * d)).reshape(c, d)
        total = float(ess.min(dim=1).values.sum())
    return total


def check_seed(ctx, index: int) -> int:
    return job_words(ctx["seed"], index, 3)
