"""Import guard: the port and chip_smoke.py import neither JAX nor the JAX
package.  A subprocess blocks ``jax``/``jaxlib`` and ``mcm_tpu`` (but not
``mcm_tpu_torch``) with a meta-path finder, then imports every module of
the port and ``chip_smoke``."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "mcm_tpu")

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import mcm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mcm_tpu_torch.__path__,
                                               "mcm_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not leaked, leaked
print(" ".join(names))
"""

#: modules the guard must reach by name (the walk finds every module; these
#: are the entry points and the modules of the vit-Linear, serving and
#: training paths)
_NAMED = ("mcm_tpu_torch.models.vit", "mcm_tpu_torch.scores.msp",
          "mcm_tpu_torch.cli.eval_msp", "mcm_tpu_torch.cli.eval_ood",
          "mcm_tpu_torch.serve", "mcm_tpu_torch.serve_http",
          "mcm_tpu_torch.train", "mcm_tpu_torch.train.contrastive",
          "mcm_tpu_torch.train.linear_probe", "mcm_tpu_torch.train.checkpoint",
          "mcm_tpu_torch.train.loop", "mcm_tpu_torch.tools.finetune_clip",
          "mcm_tpu_torch.tools.train_linear_probe",
          "mcm_tpu_torch.tools.train_attn_probe")


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    names = proc.stdout.strip().splitlines()[-1].split()
    assert len(names) >= 35
    assert set(_NAMED) <= set(names), set(_NAMED) - set(names)


def test_guard_blocks_the_jax_package():
    """The guard itself works: importing the JAX package through it fails."""
    script = _SCRIPT.replace("import mcm_tpu_torch\n",
                             "import mcm_tpu.config\nimport mcm_tpu_torch\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "blocked import of mcm_tpu" in proc.stderr
