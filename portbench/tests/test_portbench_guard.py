"""The no-JAX check compares whole top-level names, and nothing a run
imports is JAX or the JAX package."""

import os
import subprocess
import sys

import pytest

from harness import guard

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


@pytest.mark.parametrize("names,found", [
    (["ddpm3d_tpu_torch", "ddpm3d_tpu_torch.ops.quant"], []),
    (["ddpm3d_tpu", "ddpm3d_tpu.ops"], ["ddpm3d_tpu"]),
    (["jaxlib.xla_client", "jax_foo", "flaxen"], ["jaxlib"]),
    (["flax.linen", "jax"], ["flax", "jax"]),
])
def test_whole_top_level_names(names, found):
    assert guard.forbidden_modules(names) == found


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path[:0] = [{HERE!r}, {ROOT!r}]\n{code}\n"
         "print('\\n'.join(sorted({n.split('.')[0] for n in sys.modules})))"],
        capture_output=True, text=True, check=True, cwd=ROOT,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    return set(out.stdout.split())


def test_a_run_imports_no_jax():
    mods = _modules_after(
        "import run\nfrom harness import serve, report, manifest, trace, work\n"
        f"for d, n in (('drivers', 'serve_chain'), ('programs', "
        f"'SuperResModel'), ('samplers', 'ddpm')): manifest.module({HERE!r}, d, n)\n"
        "import ddpm3d_tpu_torch.inference.pipeline, ddpm3d_tpu_torch.models.factory")
    assert guard.forbidden_modules(mods) == []


def test_the_reference_imports_nothing_of_the_program():
    mods = _modules_after(
        "from reference import superres, diffusion, quant")
    assert not {"ddpm3d_tpu_torch", "ddpm3d_tpu", "jax", "jaxlib",
                "flax"} & mods
