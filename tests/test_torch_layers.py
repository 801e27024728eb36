"""The port's layering: the models layer stands below the mesh layer.

Every module of ``kiss_tpu_torch.models`` imports, and the index builds
there run (the one-block build, the blocked build over several blocks,
``FMIndex.build``), in a fresh interpreter where
``kiss_tpu_torch.parallel`` cannot be imported; and no import statement in
those modules, inside a function or not, names it."""

import ast
import pathlib
import subprocess
import sys

import kiss_tpu_torch.models

_MODELS = pathlib.Path(kiss_tpu_torch.models.__file__).parent

_PROBE = """
import importlib, importlib.abc, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "kiss_tpu_torch.parallel" or name.startswith(
                "kiss_tpu_torch.parallel."):
            raise ImportError(f"{name} is above the models layer")
        return None

sys.meta_path.insert(0, Refuse())
import numpy as np
import torch
import kiss_tpu_torch.models as models
for m in pkgutil.iter_modules(models.__path__):
    importlib.import_module(f"kiss_tpu_torch.models.{m.name}")
from kiss_tpu_torch.models import fm_index as fm
from kiss_tpu_torch.ops.suffix_sort import k_ordered_suffix_array

text = np.random.default_rng(7).integers(0, 4, 3000).astype(np.int8)
sa = k_ordered_suffix_array(text, -1, device="cpu")
one = fm.build_index_device(torch.from_numpy(text),
                            torch.from_numpy(sa.astype(np.int64)), 4)
rows = fm.build_index_rows(torch.from_numpy(text), sa, 4, block_rows=700)
for name in fm.FMArrays._fields:
    assert torch.equal(getattr(one, name), getattr(rows, name)), name
fm.FMIndex(sa_intv=4, lookup_len=2, device="cpu").build(text, sa=sa)
assert not any(k.startswith("kiss_tpu_torch.parallel") for k in sys.modules)
print("layers ok")
"""


def _imported_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def test_models_layer_imports_nothing_of_the_mesh_layer():
    for path in sorted(_MODELS.glob("*.py")):
        names = set(_imported_names(ast.parse(path.read_text())))
        up = sorted(x for x in names
                    if x == "kiss_tpu_torch.parallel"
                    or x.startswith("kiss_tpu_torch.parallel."))
        assert not up, (path.name, up)
    root = _MODELS.parent.parent
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "layers ok" in out.stdout
