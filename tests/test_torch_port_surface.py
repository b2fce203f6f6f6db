"""The port's public surface against the JAX package's, read with `ast`
alone (neither package is imported).

For every module of `tfhe_tpu` the port has a module at the same path;
every public top-level name of it (a def, a class, an assignment, or a
name its `__init__` imports from the package) is reachable there under
the same name (defined or imported); and every public function, method
and constructor takes the reference's positional parameters first, at
the same positions and under the same names, and its keyword-only ones
by name. The port's own parameters (`device`, `steps`) come after them.
What stays out on purpose is listed in EXCEPTIONS with its reason, and
an entry that is no longer needed fails the test.

Run: python -m pytest tests/test_torch_port_surface.py -q
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
REF, PORT = "tfhe_tpu", "tfhe_tpu_torch"

_DTYPE = "a JAX dtype alias; the port keeps u32/u64 bit patterns in int64 tensors (_u64.py)"

# Key forms: "path.py" (a module), "path.py:Name" or "*:Name" (a
# top-level name), "path.py:func(param)" or "path.py:Class.method(param)"
# (a reference parameter left out of the positional comparison).
EXCEPTIONS = {
    "ops/pallas_ntt.py": "Pallas kernels K1/K2; the port's are csrc/ntt.cu, launched by ops/ntt_cuda.py",
    "ops/pallas_blind_rotate.py": "Pallas kernel K3; the port's is csrc/blind_rotate.cu, launched by ops/blind_rotate_cuda.py",
    "ops/pallas_multibit.py": "Pallas kernel K4; the port's is csrc/multibit.cu, launched by ops/multibit_cuda.py",
    "version.py": "the port keeps __version__ in its own __init__.py",
    "utils/pytree.py": "jit pytree registration; nothing is traced and the port's dataclasses hold tensors (utils/__init__.py)",
    "utils/xlacache.py": "XLA's persistent compile cache; PyTorch compiles nothing per shape (utils/__init__.py)",
    "*:U64": _DTYPE,
    "*:U32": _DTYPE,
    "*:I32": _DTYPE,
    "parallel/mesh.py:make_mesh(devices)": "a list of jax devices; a port rank owns one card, so it takes `ranks` (parallel/mesh.py)",
    "parallel/multihost.py:make_host_mesh(devices)": "a list of jax devices; the port takes `ranks_per_host`",
    "parallel/multihost.py:make_cross_host_model_mesh(devices)": "a list of jax devices; the port takes `ranks_per_host`",
    "parallel/multihost.py:collective_stats(compiled_text)": "XLA's compiled HLO text; the port reads the recorder of its process-group calls (parallel/_comm.py)",
}


# -- the checker ----------------------------------------------------------------


def _params(fn: ast.FunctionDef) -> tuple[list, list, bool, bool]:
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args], [x.arg for x in a.kwonlyargs], a.vararg is not None, a.kwarg is not None


def _is_dataclass(cls: ast.ClassDef) -> bool:
    return any("dataclass" in ast.unparse(d) for d in cls.decorator_list)


def _constructor(cls: ast.ClassDef):
    """The parameters a call of the class binds: its __init__'s after self,
    else a dataclass's fields in order, else None (not checked)."""
    for b in cls.body:
        if isinstance(b, ast.FunctionDef) and b.name == "__init__":
            pos, kw, va, vk = _params(b)
            return pos[1:], kw, va, vk
    if _is_dataclass(cls):
        fields = [b.target.id for b in cls.body if isinstance(b, ast.AnnAssign) and isinstance(b.target, ast.Name)]
        return fields, [], False, False
    return None


def _top_level(src: str) -> dict:
    """name -> ("def", node) | ("class", node) | ("var", None) |
    ("import", (module, name, level))."""
    out = {}
    for node in ast.parse(src).body:
        if isinstance(node, ast.FunctionDef):
            out[node.name] = ("def", node)
        elif isinstance(node, ast.ClassDef):
            out[node.name] = ("class", node)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in node.targets if isinstance(node, ast.Assign) else [node.target]:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        out[n.id] = ("var", None)
        elif isinstance(node, ast.ImportFrom):
            for al in node.names:
                out[al.asname or al.name] = ("import", (node.module or "", al.name, node.level))
        elif isinstance(node, ast.Import):
            for al in node.names:
                out[al.asname or al.name.split(".")[0]] = ("import", None)
    return out


def _module_path(pkg: str, path: str, imp) -> str | None:
    """The package-relative module path of an ImportFrom ("a/b" for
    `pkg.a.b`, "" for `pkg` itself), or None outside `pkg`."""
    module, _, level = imp
    if level:
        base = path.split("/")[:-1]
        base = base[: len(base) - (level - 1)] if level > 1 else base
        parts = base + (module.split(".") if module else [])
    elif module == pkg or module.startswith(pkg + "."):
        parts = module.split(".")[1:]
    else:
        return None
    return "/".join(parts)


def _resolve(mods: dict, pkg: str, path: str, name: str):
    """Follow the port's imports to the def or class behind `name` in the
    module at `path`: ("def" | "class", node), ("module" | "var" |
    "external", None), or None when nothing of that name is there."""
    entry = mods[path].get(name) if path in mods else None
    if entry is None or entry[0] != "import":
        return entry
    if entry[1] is None:
        return ("external", None)
    target = _module_path(pkg, path, entry[1])
    if target is None:
        return ("external", None)
    orig = entry[1][1]
    sub = f"{target}/{orig}" if target else orig
    if f"{sub}.py" in mods or f"{sub}/__init__.py" in mods:
        return ("module", None)
    for cand in (f"{target}.py", f"{target}/__init__.py" if target else "__init__.py"):
        if cand in mods:
            return _resolve(mods, pkg, cand, orig)
    return None


def _compare(where: str, ref, port, excused: set, used: set, gaps: list):
    rpos, rkw, rva, rvk = ref
    ppos, pkw, pva, pvk = port
    rpos = [p for p in rpos if p not in excused]
    used.update(f"{where}({p})" for p in excused & set(ref[0]))
    for i, p in enumerate(rpos):
        if i < len(ppos) and ppos[i] == p:
            continue
        if p in ppos:
            gaps.append(f"{where}: parameter {p!r} out of order (position {i} in the reference, {ppos.index(p)} in the port)")
        elif p in pkw:
            gaps.append(f"{where}: parameter {p!r} is keyword-only in the port (position {i} in the reference)")
        else:
            gaps.append(f"{where}: missing parameter {p!r} (position {i} in the reference)")
    for p in rkw:
        if p not in ppos and p not in pkw:
            gaps.append(f"{where}: missing keyword parameter {p!r}")
    if rva and not pva:
        gaps.append(f"{where}: no *args in the port")
    if rvk and not pvk:
        gaps.append(f"{where}: no **kwargs in the port")


def _excused(exceptions: dict, where: str) -> set:
    """The reference parameters of `where` that the exceptions leave out."""
    return {k[len(where) + 1 : -1] for k in exceptions if k.startswith(where + "(")}


def surface_gaps(ref_sources: dict, port_sources: dict, ref_pkg: str, port_pkg: str, exceptions: dict):
    """Compare two packages given as {relative path: source}. Returns
    (gaps, used): the reference surface the port lacks, and the
    exception keys that excused something."""
    ref = {p: _top_level(s) for p, s in ref_sources.items()}
    port = {p: _top_level(s) for p, s in port_sources.items()}
    gaps, used = [], set()
    for path in sorted(ref):
        if path not in port:
            if path in exceptions:
                used.add(path)
            else:
                gaps.append(f"{path}: no counterpart module")
            continue
        is_init = path.endswith("__init__.py")
        for name, (kind, node) in ref[path].items():
            if name.startswith("_"):
                continue
            if kind == "import" and (not is_init or node is None or _module_path(ref_pkg, path, node) is None):
                continue
            keys = {f"{path}:{name}", f"*:{name}"} & set(exceptions)
            if keys:
                used |= keys
                continue
            got = _resolve(port, port_pkg, path, name)
            if got is None:
                gaps.append(f"{path}: {name}: no counterpart")
                continue
            pkind, pnode = got
            q = f"{path}:{name}"
            if kind == "def" and pkind == "def":
                _compare(q, _params(node), _params(pnode), _excused(exceptions, q), used, gaps)
            elif kind == "class" and pkind == "class":
                rctor, pctor = _constructor(node), _constructor(pnode)
                if rctor is not None and pctor is not None:
                    _compare(q, rctor, pctor, _excused(exceptions, q), used, gaps)
                pmeth = {b.name: b for b in pnode.body if isinstance(b, ast.FunctionDef)}
                for b in node.body:
                    if not isinstance(b, ast.FunctionDef) or b.name.startswith("_"):
                        continue
                    qm = f"{q}.{b.name}"
                    if b.name not in pmeth:
                        gaps.append(f"{qm}: no counterpart")
                    else:
                        _compare(qm, _params(b), _params(pmeth[b.name]), _excused(exceptions, qm), used, gaps)
    return gaps, used


def _sources(pkg: str) -> dict:
    base = REPO / pkg
    return {
        f.relative_to(base).as_posix(): f.read_text()
        for f in base.rglob("*.py")
        if "_build" not in f.relative_to(base).parts
    }


# -- the tests ------------------------------------------------------------------


def test_port_surface_matches_the_reference():
    gaps, used = surface_gaps(_sources(REF), _sources(PORT), REF, PORT, EXCEPTIONS)
    assert not gaps, "\n".join(gaps)
    assert set(EXCEPTIONS) == used, f"exceptions that excuse nothing: {sorted(set(EXCEPTIONS) - used)}"
    assert all(isinstance(r, str) and r for r in EXCEPTIONS.values())


_SYN_REF = {
    "__init__.py": "from pkg.a import f as f\nimport numpy as np\n",
    "a.py": (
        "import dataclasses\n"
        "CONST = 3\n"
        "def f(x, y, z=1, *, flag=False): ...\n"
        "def g(a): ...\n"
        "def h(a, b): ...\n"
        "class K:\n"
        "    def m(self, p, q): ...\n"
        "@dataclasses.dataclass\n"
        "class D:\n"
        "    u: int\n"
        "    v: int\n"
    ),
    "b.py": "def k(): ...\n",
}
_SYN_PORT = {
    "__init__.py": "from pkg_torch.a import f as f\n",
    "a.py": (
        "import dataclasses\n"
        "from pkg_torch.c import g\n"
        "CONST = 3\n"
        "def f(x, z=1, *, flag=False, device=None): ...\n"
        "def h(a, *, b=None): ...\n"
        "class K:\n"
        "    def m(self, q, p, *, device=None): ...\n"
        "@dataclasses.dataclass\n"
        "class D:\n"
        "    v: int\n"
        "    u: int\n"
    ),
    "c.py": "def g(a, *, device=None): ...\n",
}


_F = "def f(x, z=1, *, flag=False, device=None): ...\n"


@pytest.mark.parametrize(
    "drop, want",
    [
        ("", "a.py:f: missing parameter 'y' (position 1 in the reference)"),
        ("", "a.py:f: parameter 'z' out of order (position 2 in the reference, 1 in the port)"),
        ("", "a.py:h: parameter 'b' is keyword-only in the port (position 1 in the reference)"),
        ("", "a.py:K.m: parameter 'p' out of order (position 1 in the reference, 2 in the port)"),
        ("", "a.py:D: parameter 'u' out of order (position 0 in the reference, 1 in the port)"),
        ("", "b.py: no counterpart module"),
        ("CONST = 3\n", "a.py: CONST: no counterpart"),
        (_F, "__init__.py: f: no counterpart"),
    ],
    ids=["missing_param", "out_of_order", "keyword_only", "method", "dataclass", "module", "name", "reexport"],
)
def test_checker_reports_synthetic_gaps(drop, want):
    """The checker finds a missing module, name and parameter, and a
    parameter out of order or made keyword-only, in a port that lacks them."""
    assert _F in _SYN_PORT["a.py"]
    port = dict(_SYN_PORT, **{"a.py": _SYN_PORT["a.py"].replace(drop, "") if drop else _SYN_PORT["a.py"]})
    gaps, _ = surface_gaps(_SYN_REF, port, "pkg", "pkg_torch", {})
    assert want in gaps, gaps


def test_checker_passes_a_matching_port_and_uses_its_exceptions():
    port = dict(_SYN_PORT)
    port["a.py"] = (
        "from pkg_torch.c import g\nCONST = 3\n"
        "def f(x, y, z=1, *, flag=False, device=None): ...\n"
        "def h(a, *, device=None): ...\n"
        "class K:\n    def m(self, p, q): ...\n"
        "class D:\n    def __init__(self, u, v): ...\n"
    )
    exceptions = {"b.py": "gone on purpose", "a.py:h(b)": "not carried over"}
    gaps, used = surface_gaps(_SYN_REF, port, "pkg", "pkg_torch", exceptions)
    assert gaps == [] and used == set(exceptions)
