"""The port stands alone: it imports torch and numpy, never JAX, flax or
optax, and nothing of the JAX package ``tfk8s_tpu``.

A subprocess makes those packages unimportable (a meta-path finder that
refuses them, after dropping any copy already loaded) and imports every
module of ``tfk8s_tpu_torch`` and ``chip_smoke.py``. The finder matches
``tfk8s_tpu`` by whole name or ``tfk8s_tpu.`` prefix, so it does not
catch ``tfk8s_tpu_torch``.
"""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "tfk8s_tpu_torch")

_BLOCK = r'''
import importlib, importlib.abc, pkgutil, sys

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tfk8s_tpu")

def forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if forbidden(name):
            raise ImportError(f"the port may not import {name}")
        return None

for name in [m for m in sys.modules if forbidden(m)]:
    del sys.modules[name]
sys.meta_path.insert(0, Refuse())
'''

_IMPORT_ALL = _BLOCK + r'''
import tfk8s_tpu_torch
names = ["tfk8s_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(tfk8s_tpu_torch.__path__, "tfk8s_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules if forbidden(m))
assert not leaked, leaked
print(len(names))
'''


def _run(code):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_every_port_module_imports_without_jax_or_the_reference():
    proc = _run(_IMPORT_ALL)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 21  # the modules of both slices


@pytest.mark.parametrize("module", [
    "tfk8s_tpu_torch.ops.group_norm", "tfk8s_tpu_torch.ops.block_copy",
    "tfk8s_tpu_torch.models.resnet", "tfk8s_tpu_torch.tools.roofline",
    "tfk8s_tpu_torch.runtime.node_agent", "tfk8s_tpu_torch.obs.trace",
    "tfk8s_tpu_torch.ops.jax_random", "tfk8s_tpu_torch.runtime.paging",
    "tfk8s_tpu_torch.runtime.handoff", "tfk8s_tpu_torch.runtime.kvtier",
    "tfk8s_tpu_torch.runtime.sched", "tfk8s_tpu_torch.runtime.server",
    "tfk8s_tpu_torch.parallel.pipeline", "tfk8s_tpu_torch.models.pipelined",
    # the combined axes
    "tfk8s_tpu_torch.parallel.mesh", "tfk8s_tpu_torch.parallel.data_parallel",
    "tfk8s_tpu_torch.parallel.tensor_parallel", "tfk8s_tpu_torch.parallel.moe",
    "tfk8s_tpu_torch.parallel.ulysses", "tfk8s_tpu_torch.models.transformer",
    "tfk8s_tpu_torch.models.gpt", "tfk8s_tpu_torch.models.bert",
    "tfk8s_tpu_torch.models.t5", "tfk8s_tpu_torch.models.dlrm",
    # the text tools
    "tfk8s_tpu_torch.data.tokenizer", "tfk8s_tpu_torch.data.corpus",
])
def test_each_resnet_and_roofline_module_imports_on_its_own(module):
    proc = _run(_BLOCK + f"import {module}\n"
                "assert not [m for m in sys.modules if forbidden(m)]\n")
    assert proc.returncode == 0, proc.stderr


def test_the_guard_refuses_the_reference_but_not_the_port():
    proc = _run(_BLOCK + "import tfk8s_tpu_torch.ops.flash_attention\nimport tfk8s_tpu\n")
    assert proc.returncode != 0
    assert "the port may not import tfk8s_tpu" in proc.stderr


_IMPORT_LINE = re.compile(
    r"^\s*(import|from) (jax|flax|optax)\b|tfk8s_tpu\.|from tfk8s_tpu import")


def _sources():
    for root, _dirs, names in os.walk(PORT):
        for n in names:
            if n.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(root, n)
    yield os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, REPO))
def test_no_source_line_names_jax_or_the_reference_package(path):
    with open(path, encoding="utf-8") as f:
        bad = [f"{i}: {line.rstrip()}" for i, line in enumerate(f, 1)
               if _IMPORT_LINE.search(line)]
    assert not bad, bad
