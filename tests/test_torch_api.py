"""tomojax_torch's public surface against tomojax's, read from source.

Every public module-level function, class, method and constant of
``tomojax/`` must exist in ``tomojax_torch/`` under the same name, in the
module at the same relative path (defined there or imported into it).
For every function and method:

- tomojax's positional parameters lead the port's, in tomojax's order; the
  port may add positional parameters only after them;
- tomojax's keyword-only parameters exist in the port, positional or
  keyword-only; the port may add keyword-only parameters anywhere;
- every default tomojax gives is the port's default too, once ``jnp.X`` /
  ``jax.numpy.X`` reads ``torch.X``.

A class's annotated fields (a NamedTuple's or a dataclass's) lead the
port's, in tomojax's order.

:data:`STAYS_BEHIND` is the one list of tomojax names the port leaves out
on purpose, each with its reason (ROADMAP.md, "What stays behind"). A
stale entry fails: a name the port now has, or one tomojax no longer has.

The test reads source with ``ast`` only: it imports neither package.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "tomojax"
PORT = ROOT / "tomojax_torch"

_PALLAS = ("a Pallas TPU entry; its Hopper kernel sits behind the port's "
           "wrapper (ROADMAP.md, What stays behind)")
_BAND = ("the TPU kernel's static band budget (ROADMAP.md, What stays "
         "behind: NBB/MBA, kernel_bounds_ok, strict_bounds)")
_SHAPE = ("the TPU kernel's static shape conditions; the Hopper kernels "
          "take every shape (ROADMAP.md, What stays behind)")
_XLA = ("the jnp twin of the scalars and the XLA forward from them, both "
        "for feeding the Pallas kernel under jit; the port's one scalar "
        "function is slab_scalars_t (ROADMAP.md, What stays behind)")

#: ``{(module, name): reason}``: the tomojax names the port leaves out on
#: purpose, or keeps with another default (``name(param=)``).
STAYS_BEHIND = {
    ("kernels/slab.py", "slab_project_pallas"): _PALLAS,
    ("kernels/slab.py", "slab_project_jac_pallas"): _PALLAS,
    ("kernels/slab.py", "slab_backproject_pallas"): _PALLAS,
    ("kernels/resample.py", "resample_rows_pallas"): _PALLAS,
    ("kernels/slab.py", "kernel_bounds_ok"): _BAND,
    ("kernels/slab.py", "kernel_supported"): _SHAPE,
    **{("kernels/slab.py", c): _BAND
       for c in ("NBB", "MBA", "OFB", "PADZ", "UCH", "VCH", "WINB",
                 "XCH_A", "XP", "XPH", "NVA_PAD")},
    ("kernels/resample.py", "ROWS_PER_PROGRAM"): (
        "the Pallas resample kernel's rows per grid program (ROADMAP.md, "
        "What stays behind: lane padding and bucketing)"),
    ("core/slab_projector.py", "slab_scalars_jnp"): _XLA,
    ("core/slab_projector.py", "forward_from_scalars_xla"): _XLA,
    **{("utils/profiling.py", n): (
        "a host timer around each iteration: it times the enqueue, not the "
        "card, and nothing reads it; the port's spans and counters "
        "(profiling.span, count, records) take its place (ROADMAP.md, What "
        "stays behind: IterationTimer)")
       for n in ("IterationTimer", "IterationTimer.__init__",
                 "IterationTimer.total", "IterationTimer.mean")},
    ("align/cc.py", "align_to_reprojection(folds=)"): (
        "the port clamps folds to n_proj // 2, so as not to copy "
        "tomojax's folds=4 raising for n_proj < 8 (ROADMAP.md Queue 3, "
        "ADVICE.md r5 defects)"),
}


def _public(name: str) -> bool:
    return not name.startswith("_")


def _module_body(tree):
    """Module-level statements, looking inside ``if`` and ``try``."""
    for node in tree.body:
        if isinstance(node, ast.If):
            yield from node.body
            yield from node.orelse
        elif isinstance(node, ast.Try):
            yield from node.body
            for h in node.handlers:
                yield from h.body
            yield from node.orelse
        else:
            yield node


def _surface(path: Path, imports: bool) -> dict:
    """``{name: node or ("import", module, name)}`` of one module's public
    definitions; methods as ``Class.method``."""
    out = {}
    for node in _module_body(ast.parse(path.read_text())):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if _public(node.name):
                out[node.name] = node
        elif isinstance(node, ast.ClassDef):
            if not _public(node.name):
                continue
            out[node.name] = node
            for m in node.body:
                if (isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and (_public(m.name)
                             or m.name in ("__init__", "__call__"))):
                    out[f"{node.name}.{m.name}"] = m
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name) and _public(n.id):
                        out.setdefault(n.id, node)
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                name = a.asname or a.name.split(".")[0]
                mod = node.module if isinstance(node, ast.ImportFrom) else None
                out.setdefault(name, ("import", mod, a.name))
    return out


def _port_module(mod: str) -> Path | None:
    """``tomojax_torch.a.b`` → its file."""
    rel = Path(*mod.split(".")[1:])
    for p in (PORT / rel.with_suffix(".py"), PORT / rel / "__init__.py"):
        if p.is_file():
            return p
    return None


def _resolve(surface: dict, name: str, depth: int = 0):
    """The port's node for ``name``, following imports inside the port."""
    node = surface.get(name)
    if not (isinstance(node, tuple) and node[0] == "import"):
        return node
    _, mod, orig = node
    if depth > 4 or not mod or not mod.startswith("tomojax_torch"):
        return node
    path = _port_module(mod)
    if path is None:
        return node
    return _resolve(_surface(path, True), orig, depth + 1)


def _norm(expr) -> str:
    s = ast.unparse(expr)
    for a in ("jax.numpy.", "jnp."):
        s = s.replace(a, "torch.")
    return s


def _params(fn):
    a = fn.args
    pos = a.posonlyargs + a.args
    pos_d = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    return ([(p.arg, d) for p, d in zip(pos, pos_d)],
            [(p.arg, d) for p, d in zip(a.kwonlyargs, a.kw_defaults)],
            a.vararg is not None, a.kwarg is not None)


def _signature_faults(ref, port) -> list:
    faults = []
    rpos, rkw, rvar, rkwa = _params(ref)
    ppos, pkw, pvar, pkwa = _params(port)
    got = [n for n, _ in ppos[:len(rpos)]]
    want = [n for n, _ in rpos]
    if got != want:
        faults.append(f"positional parameters {got} != tomojax's {want}")
    pall = dict(ppos + pkw)
    for name, d in rpos + rkw:
        if name not in pall:
            if name not in want:
                faults.append(f"lacks keyword {name!r}")
            continue
        if d is not None:
            pd = pall[name]
            if pd is None or _norm(pd) != _norm(d):
                faults.append(
                    f"default {name}="
                    f"{'<none>' if pd is None else _norm(pd)} != tomojax's "
                    f"{_norm(d)}")
    if rvar and not pvar:
        faults.append("lacks *args")
    if rkwa and not pkwa:
        faults.append("lacks **kwargs")
    return faults


def _fields(cls) -> list:
    return [n.target.id for n in cls.body
            if isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name)]


def _module_faults(rel: str):
    """``(missing, faults, used)`` of one tomojax module (its path below
    ``tomojax/``): tomojax names without a port counterpart, signature
    faults, and the :data:`STAYS_BEHIND` entries that were needed."""
    missing, faults, used = [], [], set()
    ref_path, port_path = REF / rel, PORT / rel
    ref = _surface(ref_path, imports=False) if ref_path.is_file() else {}
    port = _surface(port_path, imports=True) if port_path.is_file() else {}
    for name, rnode in ref.items():
        key = (rel, name)
        if name not in port:
            if key in STAYS_BEHIND:
                used.add(key)
            else:
                missing.append(name)
            continue
        pnode = _resolve(port, name)
        if isinstance(rnode, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not isinstance(pnode, (ast.FunctionDef, ast.AsyncFunctionDef)):
                faults.append(f"{name}: not a function in the port")
                continue
            for f in _signature_faults(rnode, pnode):
                k = (rel, f"{name}({f.split('=')[0].split()[-1]}=)")
                if f.startswith("default ") and k in STAYS_BEHIND:
                    used.add(k)
                else:
                    faults.append(f"{name}: {f}")
        elif isinstance(rnode, ast.ClassDef):
            if not isinstance(pnode, ast.ClassDef):
                faults.append(f"{name}: not a class in the port")
                continue
            want = _fields(rnode)
            got = _fields(pnode)[:len(want)]
            if got != want:
                faults.append(f"{name}: fields {got} != tomojax's {want}")
    return missing, faults, used


MODULES = sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py"))


@pytest.mark.parametrize("rel", MODULES)
def test_module_follows_tomojax(rel):
    """Every public name of the tomojax module is in the port's module at
    the same path, with tomojax's parameters, order and defaults."""
    missing, faults, _ = _module_faults(rel)
    assert not missing, (
        f"{rel}: tomojax names missing from tomojax_torch (port them, or "
        f"add them to STAYS_BEHIND with a reason): {missing}")
    assert not faults, "\n  ".join([f"{rel}: signatures differ:"] + faults)


@pytest.mark.parametrize("key", sorted(STAYS_BEHIND),
                         ids=lambda k: f"{k[0]}::{k[1]}" if isinstance(k, tuple)
                         else str(k))
def test_stays_behind_entry_is_current(key):
    """Each entry names a tomojax name the port still leaves out (or a
    default it still keeps otherwise), and cites the ROADMAP."""
    rel, _ = key
    _, _, used = _module_faults(rel)
    assert key in used, (
        f"stale STAYS_BEHIND entry {key}: the port now has it, or tomojax "
        "no longer has it")
    assert "ROADMAP.md" in STAYS_BEHIND[key]
