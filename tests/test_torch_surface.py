"""The port's public surface against the JAX package's, name by name.

For every ``.py`` module of ``lungmask_tpu/``, parsed with ``ast`` (nothing
is imported), each public top-level ``def``/``class`` and each ``__all__``
entry must have a namesake bound at the top level of the port's module of
the same path (a ``def``, ``class``, assignment or import), or a row in
:data:`TABLE`: either its counterpart in the port (``path.py:Name`` or
``path.py:Class.method``, which must exist) or a one-line reason it has
none. A row whose name has since gained a namesake, or whose name the JAX
package no longer defines, fails too, so the table stays the exact list of
differences.

Keywords likewise: every parameter that a JAX public function, or a public
class's ``__init__`` or public method, takes by name must be a parameter of
the port's namesake (or the namesake takes ``**kwargs``), unless a row of
:data:`KEYWORD_TABLE` names it with the reason. A row must name exactly the
keywords its namesake lacks: one no longer needed fails.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "lungmask_tpu")
PORT_ROOT = os.path.join(REPO, "lungmask_tpu_torch")

PORTED, NOT_PORTED = "ported as", "not ported"
_XLA_PROGRAMS = "bounds the number of XLA programs; torch compiles nothing per shape"
_DEVICE_PASTE = ("a device paste plan that no JAX path calls (the paste is the host "
                 "core's lm_paste_masks, ops/resample.py:paste_masks_host in both)")

# "<module path>:<name>" → (PORTED, "<port path>:<name>") or (NOT_PORTED, reason).
TABLE = {
    "models/__init__.py:unet_apply": (PORTED, "models/unet.py:UNet.forward"),
    "models/unet.py:unet_apply": (PORTED, "models/unet.py:UNet.forward"),
    "models/unet.py:cast_params": (
        NOT_PORTED, "no JAX caller; UNet(params, compute_dtype) casts the kernels as the "
                    "JAX engine's _cast_kernels does"),
    "ops/cc.py:largest_component_mask_last_tie": (
        PORTED, "transforms/postprocess_device.py:_largest_cc_per_class"),
    "ops/pallas/bodymask.py:bodymask_labels_pallas": (
        PORTED, "ops/kernels/bodymask.py:bodymask_labels"),
    "ops/pallas/stencil.py:avg_pool2_pallas": (PORTED, "ops/kernels/stencil.py:avg_pool2"),
    "ops/pallas/stencil.py:bilinear_up2_pallas": (PORTED, "ops/kernels/stencil.py:bilinear_up2"),
    "ops/resample.py:apply_paste": (NOT_PORTED, _DEVICE_PASTE),
    "ops/resample.py:paste_plan": (NOT_PORTED, _DEVICE_PASTE),
    "ops/resample.py:paste_resized_into_box": (NOT_PORTED, _DEVICE_PASTE),
    "ops/resample.py:resize_from_box": (NOT_PORTED, "only preprocess_traced calls it"),
    "ops/resample.py:zoom_output_shape": (
        NOT_PORTED, "no JAX path calls it (only tests/test_resample.py)"),
    "parallel/mesh.py:ensure_host_devices": (
        NOT_PORTED, "sets XLA's host device count for CPU meshes; a port mesh repeats a "
                    "device instead (make_mesh(devices=['cpu'] * n))"),
    "runtime/__init__.py:enable_compile_cache": (NOT_PORTED, "XLA's persistent compile cache"),
    "runtime/__init__.py:start_cache_telemetry": (
        NOT_PORTED, "counts XLA compile-cache traffic (runtime/cache_telemetry.py)"),
    "runtime/cache_telemetry.py:CacheTelemetry": (NOT_PORTED, "XLA compile-cache telemetry"),
    "runtime/cache_telemetry.py:start_cache_telemetry": (
        NOT_PORTED, "XLA compile-cache telemetry"),
    "runtime/engine.py:bucket_chunks": (NOT_PORTED, _XLA_PROGRAMS),
    "runtime/engine.py:split_parts": (NOT_PORTED, _XLA_PROGRAMS),
    "runtime/engine.py:volume_argmax_packed": (PORTED, "runtime/engine.py:pack_bits"),
    "runtime/engine.py:volume_argmax_pair": (PORTED, "runtime/engine.py:run_pair"),
    "transforms/preprocess.py:default_use_pallas": (
        PORTED, "ops/kernels/bodymask.py:bodymask_labels"),
    "transforms/preprocess.py:pad_slices": (NOT_PORTED, _XLA_PROGRAMS),
    "transforms/preprocess.py:preprocess_traced": (
        NOT_PORTED, "the jit-traceable preprocessing of XLA programs; no JAX path calls it"),
}

_TAKES_A_UNET = ("the port takes a UNet module, which holds the weights cast to its compute "
                 "dtype, where JAX takes the params tree and the compute options")

# "<module path>:<function or Class.method>" → (keywords the port lacks, reason).
KEYWORD_TABLE = {
    "models/unet.py:init_params": (
        ("key", "dtype"), "draws from a torch.Generator (generator=), float32 on the CPU, "
                          "where JAX takes a PRNG key and a dtype"),
    "models/unet.py:unet_argmax": (("params", "compute_dtype", "precision"), _TAKES_A_UNET),
    "models/unet.py:unet_logits": (("params", "compute_dtype", "precision"), _TAKES_A_UNET),
    "runtime/engine.py:volume_argmax": (("params", "compute_dtype"), _TAKES_A_UNET),
    "runtime/engine.py:volume_argmax_packed2": (("params", "compute_dtype"), _TAKES_A_UNET),
    "runtime/engine.py:volume_argmax_pair_packed": (
        ("params_a", "params_b", "compute_dtype"), _TAKES_A_UNET),
    "runtime/serve.py:serve_forever": (
        ("warmup",), "the CLI's --warmup (cli._warmup) is the one warm-up; the lane has none"),
}


def public_names(path: str) -> set:
    """Public top-level ``def``/``class`` names and ``__all__`` entries."""
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if not node.name.startswith("_"):
                names.add(node.name)
        elif isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            names.update(ast.literal_eval(node.value))
    return names


def bound_names(path: str) -> set:
    """Names bound at the top level (``def``, ``class``, assignment,
    import), and ``Class.method`` for each class's methods."""
    if not os.path.exists(path):
        return set()
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            names.update(f"{node.name}.{m.name}" for m in node.body
                         if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for target in node.targets if isinstance(node, ast.Assign) else [node.target]:
                names.update(n.id for n in ast.walk(target) if isinstance(n, ast.Name))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return names


def keywords(path: str) -> dict:
    """``name`` or ``Class.method`` → (the parameters it takes by name,
    whether it takes ``**kwargs``), for each top-level function and each
    class's ``__init__`` and public methods; ``self``/``cls`` dropped,
    positional-only parameters left out."""
    if not os.path.exists(path):
        return {}
    tree = ast.parse(open(path, encoding="utf-8").read(), path)

    def named(fn, method):
        names = [a.arg for a in fn.args.args + fn.args.kwonlyargs]
        if method and names and names[0] in ("self", "cls"):
            names = names[1:]
        return tuple(names), fn.args.kwarg is not None

    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = named(node, False)
        elif isinstance(node, ast.ClassDef):
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
                        m.name == "__init__" or not m.name.startswith("_")):
                    out[f"{node.name}.{m.name}"] = named(m, True)
    return out


def missing_keywords(jax_root: str, port_root: str, rel: str) -> dict:
    """Each public function or method of ``jax_root/rel`` whose namesake in
    ``port_root/rel`` lacks some of its keywords → those keywords."""
    theirs = keywords(os.path.join(port_root, rel))
    out = {}
    for name, (names, _) in keywords(os.path.join(jax_root, rel)).items():
        if name.split(".")[0].startswith("_") or name not in theirs or theirs[name][1]:
            continue
        lacks = tuple(k for k in names if k not in theirs[name][0])
        if lacks:
            out[name] = lacks
    return out


def keyword_gaps(jax_root: str, port_root: str, rel: str, table: dict) -> list:
    """``name(keyword)`` for each keyword a namesake lacks that no row of
    ``table`` names."""
    return sorted(f"{name}({k})" for name, lacks in
                  missing_keywords(jax_root, port_root, rel).items()
                  for k in lacks if k not in table.get(f"{rel}:{name}", ((), ""))[0])


def gaps(jax_root: str, port_root: str, rel: str, table: dict) -> list:
    """The public names of ``jax_root/rel`` with neither a namesake in
    ``port_root/rel`` nor a row in ``table``."""
    have = bound_names(os.path.join(port_root, rel))
    return sorted(n for n in public_names(os.path.join(jax_root, rel))
                  if n not in have and f"{rel}:{n}" not in table)


def _modules(root: str) -> list:
    out = []
    for directory, _, files in os.walk(root):
        out += [os.path.relpath(os.path.join(directory, f), root)
                for f in files if f.endswith(".py")]
    return sorted(out)


JAX_MODULES = [rel for rel in _modules(JAX_ROOT)
               if public_names(os.path.join(JAX_ROOT, rel))]


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_name_has_a_namesake_or_a_row(rel):
    missing = gaps(JAX_ROOT, PORT_ROOT, rel, TABLE)
    assert not missing, (
        f"lungmask_tpu/{rel}: {missing} have no namesake in lungmask_tpu_torch/{rel}; "
        "port them or add a row to TABLE")


@pytest.mark.parametrize("row", sorted(TABLE))
def test_every_row_is_needed_and_its_counterpart_exists(row):
    rel, name = row.split(":")
    assert name in public_names(os.path.join(JAX_ROOT, rel)), f"{row}: not in the JAX package"
    assert name not in bound_names(os.path.join(PORT_ROOT, rel)), (
        f"{row}: the port has a namesake now; drop the row")
    kind, what = TABLE[row]
    assert kind in (PORTED, NOT_PORTED)
    if kind == PORTED:
        port_rel, port_name = what.split(":")
        assert port_name in bound_names(os.path.join(PORT_ROOT, port_rel)), (
            f"{row}: lungmask_tpu_torch/{what} does not exist")
    else:
        assert what and "\n" not in what


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_keyword_has_a_namesake_or_a_row(rel):
    missing = keyword_gaps(JAX_ROOT, PORT_ROOT, rel, KEYWORD_TABLE)
    assert not missing, (
        f"lungmask_tpu/{rel}: the port's namesakes lack the keywords {missing}; "
        "take them or add a row to KEYWORD_TABLE")


@pytest.mark.parametrize("row", sorted(KEYWORD_TABLE))
def test_every_keyword_row_is_needed(row):
    rel, name = row.split(":")
    kws, reason = KEYWORD_TABLE[row]
    assert reason and "\n" not in reason
    lacks = missing_keywords(JAX_ROOT, PORT_ROOT, rel).get(name, ())
    assert tuple(sorted(lacks)) == tuple(sorted(kws)), (
        f"{row}: the port's namesake lacks {lacks}, the row names {kws}; correct the row")


def test_a_keyword_with_neither_fails(tmp_path):
    """The keyword check itself: a keyword a namesake lacks is reported
    (functions, ``__init__`` and public methods; positional-only
    parameters, private methods and names without a namesake are not
    checked), ``**kwargs`` takes any, and a row clears the keywords it
    names and no other."""
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    jax_root.mkdir()
    port_root.mkdir()
    (jax_root / "m.py").write_text(
        "def f(a, /, b, c=1, *, d=2): pass\n"
        "def g(x, y): pass\n"
        "def alone(z): pass\n"
        "class C:\n"
        "    def __init__(self, p, q=0): pass\n"
        "    def run(self, r, s=0): pass\n"
        "    def _hidden(self, t): pass\n")
    (port_root / "m.py").write_text(
        "def f(b, d=2): pass\n"
        "def g(x, **kw): pass\n"
        "class C:\n"
        "    def __init__(self, p): pass\n"
        "    def run(self, r): pass\n"
        "    def _hidden(self): pass\n")
    assert keyword_gaps(str(jax_root), str(port_root), "m.py", {}) == [
        "C.__init__(q)", "C.run(s)", "f(c)"]
    table = {"m.py:f": (("c",), "a reason"), "m.py:C.run": (("r",), "a stale reason")}
    assert keyword_gaps(str(jax_root), str(port_root), "m.py", table) == [
        "C.__init__(q)", "C.run(s)"]
    assert missing_keywords(str(jax_root), str(port_root), "m.py") == {
        "f": ("c",), "C.__init__": ("q",), "C.run": ("s",)}


def test_a_name_with_neither_fails(tmp_path):
    """The check itself: a JAX module's public names with no namesake and no
    row are reported, a missing port module reports them all, and a row or
    a namesake (def, class, import, assignment or ``__all__``) clears one."""
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    for root in (jax_root, port_root):
        (root / "sub").mkdir(parents=True)
    (jax_root / "sub" / "m.py").write_text(
        "import os\n__all__ = ['exported']\nexported = 1\n"
        "def kept(): pass\ndef lost(): pass\ndef _private(): pass\nclass Lost2: pass\n")
    (jax_root / "only.py").write_text("def alone(): pass\n")
    assert gaps(str(jax_root), str(port_root), "only.py", {}) == ["alone"]
    assert gaps(str(jax_root), str(port_root), "sub/m.py", {}) == [
        "Lost2", "exported", "kept", "lost"]
    (port_root / "sub" / "m.py").write_text(
        "from x import kept\nexported = 2\nclass Other:\n    def lost(self): pass\n")
    assert gaps(str(jax_root), str(port_root), "sub/m.py", {}) == ["Lost2", "lost"]
    table = {"sub/m.py:lost": (NOT_PORTED, "a reason")}
    assert gaps(str(jax_root), str(port_root), "sub/m.py", table) == ["Lost2"]
