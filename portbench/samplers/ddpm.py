"""The DDPM ancestral chain over a respaced schedule: the program's entry
runs it by default; the reference's table and step, with the step noise of
each step drawn from (seed, patch, step)."""

from reference import diffusion

# each step but the last adds noise drawn as the program draws it
STEP_NOISE = True


def entry_kwargs(params: dict) -> dict:
    """The entry's arguments that select this sampler."""
    return {}


def tables(cfg: dict, params: dict):
    if cfg["noise_schedule"] != "linear":
        raise ValueError(f"no reference schedule {cfg['noise_schedule']!r}")
    return diffusion.chain_tables(cfg["diffusion_steps"], params["respacing"])


def step(tab, out, x, i, noise, clip):
    return diffusion.ancestral_step(tab, out, x, i, noise, clip)
