"""The port stands alone: no file of `stark_tpu_torch/` and not
`chip_smoke.py` imports jax, jaxlib or the JAX package `stark_tpu`, and
every module of the contact, staged-solver, element-derivative and
rods-and-volumes slices imports without a card or nvcc."""
import ast
import importlib
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "stark_tpu")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, files in os.walk(os.path.join(ROOT, "stark_tpu_torch")):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    roots = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.append(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                roots.append(str(node.args[0].value).split(".")[0])
    return roots


def _module_name(path):
    rel = os.path.relpath(path, ROOT)[:-len(".py")].replace(os.sep, ".")
    return rel[:-len(".__init__")] if rel.endswith(".__init__") else rel


# the rigid-body and contact slices (friction included): every module must
# exist and import
CONTACT_SLICE = [
    "stark_tpu_torch.collision.narrow_phase",
    "stark_tpu_torch.collision.broad_phase",
    "stark_tpu_torch.ops.grid_build",
    "stark_tpu_torch.ops.rowk_select",
    "stark_tpu_torch.models.rigid_dynamics",
    "stark_tpu_torch.models.rigidbodies.inertia_tensors",
    "stark_tpu_torch.models.rigidbodies.inertia",
    "stark_tpu_torch.models.rigidbodies.constraints",
    "stark_tpu_torch.models.rigidbodies.joints",
    "stark_tpu_torch.models.rigidbodies.rigidbodies",
    "stark_tpu_torch.models.interactions.contact",
    "stark_tpu_torch.models.interactions.contact_energies",
    "stark_tpu_torch.models.interactions.contact_engine",
    "stark_tpu_torch.models.interactions.interactions",
    "stark_tpu_torch.ops.compact",
    "stark_tpu_torch.ops.ball_wide",
    "stark_tpu_torch.ops.narrow",
    "stark_tpu_torch.ops.segment_triangle",
    "stark_tpu_torch.ops.friction_pairs",
    "stark_tpu_torch.ops.friction_rows",
]


# the staged solver's slice: its solver stages, the kernels it launches
# (B at its staged site, A, C's selective mask, D, I's contact mode) and the
# host plumbing of the per-evaluation contact refresh
STAGED_SLICE = [
    "stark_tpu_torch.solver.newton",
    "stark_tpu_torch.solver.assembly",
    "stark_tpu_torch.solver.project",
    "stark_tpu_torch.solver.pcg",
    "stark_tpu_torch.ops.hvp_bucket",
    "stark_tpu_torch.ops.segment_reduce",
    "stark_tpu_torch.ops.pd_project",
    "stark_tpu_torch.ops.block3",
    "stark_tpu_torch.simulation",
    "stark_tpu_torch.core.stark",
]


# the element-derivative slice: kernels M-S's launcher and twin, the
# models that register their families' tables with it, and the seeded
# tables their checks use
EGH_SLICE = [
    "stark_tpu_torch.ops.egh",
    "stark_tpu_torch.models.deformables.energies",
    "stark_tpu_torch.models.rigidbodies.inertia",
    "stark_tpu_torch.models.rigidbodies.constraints",
    "stark_tpu_torch.models.interactions.contact_energies",
    "stark_tpu_torch.tools.egh_cases",
]


# the rods-and-volumes slice: the deformables aggregate and presets that
# register segment and tet strain (kernels R, S), the friction kernel Q's
# families, and the scene builders and finite-difference check of its tests
VOLUME_SLICE = [
    "stark_tpu_torch.models.deformables.deformables",
    "stark_tpu_torch.presets.presets",
    "stark_tpu_torch.tools.scenes",
    "stark_tpu_torch.tools.fd_check",
    "stark_tpu_torch.utils.mesh_utils",
    "stark_tpu_torch.utils.mesh_generators",
]


def test_port_has_files():
    files = _port_files()
    assert len(files) > 20
    assert any(f.endswith("solver/fused.py") for f in files)
    names = {_module_name(f) for f in files}
    assert set(CONTACT_SLICE) <= names
    assert set(STAGED_SLICE) <= names
    assert set(EGH_SLICE) <= names
    assert set(VOLUME_SLICE) <= names


@pytest.mark.parametrize("name", CONTACT_SLICE + STAGED_SLICE + EGH_SLICE + VOLUME_SLICE)
def test_contact_slice_module_imports(name):
    """Each module of the contact slice imports on a machine without a card
    or nvcc (no kernel is built at import time)."""
    mod = importlib.import_module(name)
    assert not any(hasattr(mod, n) for n in ("jax", "jnp"))


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = [r for r in _imported_roots(path) if r in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_import_module_names_are_not_built_dynamically():
    """`importlib.import_module` with a JAX name would dodge the scan."""
    for path in _port_files():
        src = open(path).read()
        for name in FORBIDDEN:
            assert f'import_module("{name}' not in src
            assert f"import_module('{name}" not in src
