"""PyTorch port: the rules every file of ``math_tpu_torch`` keeps.

- the port, ``chip_smoke.py`` and ``tools/{constrained,univariate}_models.py``
  (the user models ``chip_smoke.py`` drives) import nothing of JAX, of the
  JAX package or of Triton (an AST walk over every import statement);
- the special functions and the densities never take a tensor's values to
  the host: no ``.cpu()``, ``.numpy()``, ``.item()`` or ``.tolist()`` and no
  scipy in ``math_tpu_torch/special/`` and ``math_tpu_torch/dists/`` (numpy
  builds constant node tables at import; a CUDA tensor computes on the card
  or raises);
- lower layers do not import higher ones (the layer order of
  ``tests/test_layering.py``);
- the kernel loader raises a clear error where there is no ``nvcc`` and does
  not hand back the plain version; the kernel wrapper refuses a device it has
  no kernel for instead of computing elsewhere;
- ``torch.linalg.cholesky`` appears under ``math_tpu_torch/ops/`` only inside a
  function whose name ends in ``_reference``: no library factorization stands
  in for the hand-written block kernel;
- no file of the port names a TPU generation (a number measured on one is not
  the port's);
- style: no tabs, no trailing whitespace, no line over 160 columns, a module
  docstring in every module.
"""

import ast
import os
import shutil

import pytest
import torch

from math_tpu_torch import get_config, update_config
from math_tpu_torch.ops import _build, chol_blocked, glm_fused, lv_rk4

ROOT = os.path.join(os.path.dirname(__file__), "..")
PKG = os.path.join(ROOT, "math_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "math_tpu", "triton")
MAX_LINE = 160
KERNEL_SOURCES = [
    "math_tpu_torch/csrc/glm_fused.cu", "math_tpu_torch/csrc/glm_categorical.cu", "math_tpu_torch/csrc/tf32x3.cuh",
    "math_tpu_torch/csrc/chol_inv_block.cu", "math_tpu_torch/csrc/lv_rk4.cu",
]
GLM_SOURCES = ("math_tpu_torch/csrc/glm_fused.cu", "math_tpu_torch/csrc/glm_categorical.cu")
TPU_GENERATIONS = ("v5e", "v5p", "v6e", "v4-8")

LAYER = {
    "utils": 0,
    "special": 0,
    "config": 0,
    "transforms": 1,
    "ops": 1,
    "dists": 2,
    "model": 3,
    "diagnostics": 3,
    "io": 3,
    "infer": 4,
    "models": 4,
    "convert": 5,
}


def _port_files():
    out = ["chip_smoke.py", "tools/constrained_models.py", "tools/univariate_models.py", "tools/univariate_phases.py"]
    for dirpath, _, files in os.walk(PKG):
        for fn in sorted(files):
            if fn.endswith(".py"):
                out.append(os.path.relpath(os.path.join(dirpath, fn), ROOT).replace(os.sep, "/"))
    return sorted(out)


def _imports_of(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Import):
            for a in node.names:
                yield a.name


@pytest.mark.parametrize("rel", _port_files())
def test_no_forbidden_imports(rel):
    bad = [m for m in _imports_of(os.path.join(ROOT, rel)) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{rel} imports {bad}"


def test_port_has_the_slice_modules():
    files = set(_port_files())
    for rel in (
        "chip_smoke.py", "math_tpu_torch/config.py", "math_tpu_torch/model.py", "math_tpu_torch/convert.py",
        "math_tpu_torch/utils/propto.py", "math_tpu_torch/dists/_util.py", "math_tpu_torch/dists/continuous.py",
        "math_tpu_torch/dists/glm.py", "math_tpu_torch/transforms/scalar.py", "math_tpu_torch/transforms/api.py",
        "math_tpu_torch/ops/glm_fused.py", "math_tpu_torch/ops/_build.py", "math_tpu_torch/infer/nuts.py",
        "math_tpu_torch/infer/adapt.py", "math_tpu_torch/infer/pooled.py", "math_tpu_torch/diagnostics/convergence.py",
        "math_tpu_torch/models/glm_logistic.py", "math_tpu_torch/models/eight_schools.py",
        "math_tpu_torch/ops/chol_blocked.py", "math_tpu_torch/ops/cholesky.py", "math_tpu_torch/ops/gp.py",
        "math_tpu_torch/dists/multivariate.py", "math_tpu_torch/models/gp_regression.py",
        "math_tpu_torch/transforms/vector.py", "math_tpu_torch/special/basic.py", "math_tpu_torch/dists/discrete.py",
        "math_tpu_torch/ops/segment.py", "math_tpu_torch/models/radon.py", "math_tpu_torch/infer/advi.py",
        "math_tpu_torch/infer/smc.py", "math_tpu_torch/infer/resume.py", "math_tpu_torch/io/checkpoint.py",
        "math_tpu_torch/io/draw_store.py", "math_tpu_torch/ops/ode.py", "math_tpu_torch/ops/lv_rk4.py",
        "math_tpu_torch/models/lotka_volterra.py", "math_tpu_torch/transforms/matrix.py", "math_tpu_torch/ops/linalg.py",
        "tools/constrained_models.py", "math_tpu_torch/special/incbeta.py", "math_tpu_torch/special/hyper.py",
        "math_tpu_torch/special/bessel.py", "math_tpu_torch/special/owens_t.py", "math_tpu_torch/dists/more.py",
        "math_tpu_torch/dists/deprecated.py", "tools/univariate_models.py",
    ):
        assert rel in files, rel
    for name in KERNEL_SOURCES:
        assert os.path.isfile(os.path.join(ROOT, name)), name


def test_layer_dag():
    violations = []
    for rel in _port_files():
        if not rel.startswith("math_tpu_torch/"):
            continue
        parts = rel[len("math_tpu_torch/"):].replace(".py", "").split("/")
        src_layer = LAYER.get(parts[0])
        if src_layer is None:
            continue
        for mod in _imports_of(os.path.join(ROOT, rel)):
            if not mod.startswith("math_tpu_torch."):
                continue
            tgt_layer = LAYER.get(mod.split(".")[1])
            if tgt_layer is not None and tgt_layer > src_layer:
                violations.append(f"{rel} (L{src_layer}) -> {mod} (L{tgt_layer})")
    assert not violations, "layering violations:\n" + "\n".join(violations)


@pytest.mark.parametrize("rel", _port_files() + KERNEL_SOURCES)
def test_style(rel):
    with open(os.path.join(ROOT, rel), encoding="utf-8") as f:
        src = f.read()
    problems = []
    for i, line in enumerate(src.splitlines(), 1):
        if "\t" in line:
            problems.append(f"{rel}:{i}: tab character")
        if line != line.rstrip():
            problems.append(f"{rel}:{i}: trailing whitespace")
        if len(line) > MAX_LINE and "http" not in line:
            problems.append(f"{rel}:{i}: line length {len(line)} > {MAX_LINE}")
    if rel.endswith(".py"):
        stripped = src.lstrip()
        if stripped.startswith("#!"):
            stripped = stripped.split("\n", 1)[1].lstrip()
        if not stripped.startswith('"""'):
            problems.append(f"{rel}:1: missing module docstring")
    assert not problems, "\n".join(problems)


@pytest.mark.parametrize("rel", _port_files() + KERNEL_SOURCES)
def test_no_tpu_generation_is_named(rel):
    with open(os.path.join(ROOT, rel), encoding="utf-8") as f:
        src = f.read()
    found = [g for g in TPU_GENERATIONS if g in src]
    assert not found, f"{rel} names {found}: a number taken on a TPU is not the port's"


def _calls_outside_reference(path, dotted):
    """Names of the functions of ``path`` (or ``<module>``) that mention the
    attribute chain ``dotted`` and are not called ``*_reference``."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    bad = []

    def visit(node, owner):
        for child in ast.iter_child_nodes(node):
            inner = child.name if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) else owner
            if isinstance(child, ast.Attribute) and ast.unparse(child) == dotted and not owner.endswith("_reference"):
                bad.append(owner)
            visit(child, inner)

    visit(tree, "<module>")
    return bad


@pytest.mark.parametrize("rel", [r for r in _port_files() if r.startswith("math_tpu_torch/ops/")])
def test_no_library_cholesky_outside_reference_functions(rel):
    bad = _calls_outside_reference(os.path.join(ROOT, rel), "torch.linalg.cholesky")
    assert not bad, f"{rel}: torch.linalg.cholesky in {bad}"


def test_the_cholesky_rule_sees_a_call(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import torch\ndef f(a):\n    return torch.linalg.cholesky(a)\ndef g_reference(a):\n    return torch.linalg.cholesky(a)\n")
    assert _calls_outside_reference(str(src), "torch.linalg.cholesky") == ["f"]


def test_kernel_loader_raises_without_nvcc(tmp_path):
    """No compiler: the loader raises and names the reason; it has nothing to
    hand back in the kernel's place."""
    if shutil.which("nvcc") or os.path.isfile("/usr/local/cuda/bin/nvcc") or os.environ.get("CUDA_HOME"):
        pytest.skip("nvcc is installed here; the loader would build the kernel")
    old = get_config().kernel_build_dir
    update_config(kernel_build_dir=str(tmp_path / "build"))
    try:
        with pytest.raises(_build.KernelCompileError, match="nvcc not found"):
            _build.load_library("glm_fused")
        with pytest.raises(_build.KernelCompileError, match="nvcc not found"):
            glm_fused._library()
        with pytest.raises(_build.KernelCompileError, match="nvcc not found"):
            glm_fused._categorical_library()
        with pytest.raises(_build.KernelCompileError, match="nvcc not found"):
            chol_blocked._library()
        with pytest.raises(_build.KernelCompileError, match="nvcc not found"):
            lv_rk4._library()
    finally:
        update_config(kernel_build_dir=old)
    assert not os.path.exists(tmp_path / "build")
    assert glm_fused._lib is None and glm_fused._cat_lib is None and chol_blocked._lib is None and lv_rk4._lib is None


GLM_ENTRY_POINTS = (
    "glm_fused_launch", "glm_ordered_launch",
    "glm_categorical_launch", "glm_categorical_smem_bytes", "glm_categorical_chains_per_tile",
    "glm_categorical_wide_launch", "glm_categorical_wide_smem_bytes",
)


@pytest.mark.parametrize("entry", GLM_ENTRY_POINTS)
def test_glm_entry_point_is_declared_and_bound(entry):
    """Each C entry point the GLM loaders bind is declared ``extern "C"`` in
    one of the two GLM sources (kernels 1 and 2 in ``glm_fused.cu``, the
    categorical kernel in ``glm_categorical.cu``), and the wrappers name it."""
    cu = ""
    for rel in GLM_SOURCES:
        with open(os.path.join(ROOT, rel), encoding="utf-8") as f:
            cu += f.read()
    with open(os.path.join(PKG, "ops", "glm_fused.py"), encoding="utf-8") as f:
        py = f.read()
    assert f' {entry}(' in "".join(line for line in cu.splitlines(True) if line.startswith('extern "C"')), entry
    assert entry in py, entry


def test_kernel_wrapper_computes_only_on_cpu_or_cuda():
    """A tensor that lies neither on the CPU nor on a GPU is refused: the
    wrapper never moves the work to another device."""
    before = dict(glm_fused.PLAIN_CALLS)
    y = torch.empty(8, device="meta")
    x = torch.empty(8, 3, device="meta")
    a = torch.empty(2, device="meta")
    b = torch.empty(3, 2, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        glm_fused.glm_fused_parts("bernoulli_logit", y, x, a, b)
    with pytest.raises(ValueError, match="is on cpu"):
        glm_fused.glm_fused_parts("bernoulli_logit", torch.zeros(8), x, a, b)
    assert glm_fused.PLAIN_CALLS == before


def test_config_defaults():
    cfg = get_config()
    assert cfg.device == "cuda" and cfg.default_dtype == torch.float32
    assert cfg.cholesky_block_size == 128 and not hasattr(cfg, "thresholds")
    assert os.path.basename(cfg.kernel_build_dir) == "_build"
    with open(os.path.join(ROOT, ".gitignore"), encoding="utf-8") as f:
        assert "math_tpu_torch/_build/" in f.read().split()


HOST_READS = (".cpu(", ".numpy(", ".item(", ".tolist(")


@pytest.mark.parametrize("rel", [r for r in _port_files() if r.startswith(("math_tpu_torch/special/", "math_tpu_torch/dists/"))])
def test_no_host_round_trip_in_special_and_dists(rel):
    with open(os.path.join(ROOT, rel), encoding="utf-8") as f:
        src = f.read()
    found = [h for h in HOST_READS if h in src]
    assert not found, f"{rel} reads tensor values to the host: {found}"
    assert not [m for m in _imports_of(os.path.join(ROOT, rel)) if m.split(".")[0] == "scipy"], f"{rel} imports scipy"
