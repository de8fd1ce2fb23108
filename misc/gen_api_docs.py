"""Generate docs/api.md from the package's docstrings.

The analog of the reference's Sphinx/Doxygen API tree
(/root/reference/docs/source/api/api.rst): every public class, method and
function of the documented modules, with signatures and full docstrings
(which carry the reference file:line parity citations).

Usage:  python misc/gen_api_docs.py   (rewrites docs/api.md)
"""

from __future__ import annotations

import importlib
import inspect
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "docs", "api.md")

# (module, [symbols]) — None means: everything in __all__ or all public
# classes/functions defined in the module
SECTIONS = [
    ("Controllers", "libmpc_tpu", ["LMPC", "NLMPC"]),
    ("Types & parameters", "libmpc_tpu.types",
     ["Parameters", "LParameters", "NLParameters", "Result", "OptSequence",
      "ResultStatus", "HorizonSlice", "ConstraintsType", "default_dtype"]),
    ("Problem dimensions", "libmpc_tpu.dims", ["LDims", "NLDims"]),
    ("Fleet parallelism", "libmpc_tpu.parallel.fleet",
     ["LMPCFleet", "NLMPCFleet", "FleetStats"]),
    ("Device meshes", "libmpc_tpu.parallel.mesh", None),
    ("Model-parallel QP", "libmpc_tpu.parallel.qp_sharded",
     ["solve_sharded", "ShardedQPSolution"]),
    ("On-device closed loops", "libmpc_tpu.rollout",
     ["lmpc_rollout", "nlmpc_rollout", "Rollout"]),
    ("QP solver (OSQP-equivalent ADMM)", "libmpc_tpu.ops.admm",
     ["admm_solve", "prepare_qp", "QPSolution", "PreparedQP"]),
    ("NLP solver (SQP)", "libmpc_tpu.ops.sqp",
     ["sqp_solve", "inner_engine", "SQPSolution"]),
    ("Inner-QP engines", "libmpc_tpu.ops.qp_inner_pallas",
     ["solve_batched", "make_inner_qp_solver", "supported"]),
    ("Interior-point engine", "libmpc_tpu.ops.pdip", ["pdip_solve"]),
    ("Utilities: discretization", "libmpc_tpu.utils.discretization", None),
    ("Utilities: integrators", "libmpc_tpu.utils.integrators", None),
    ("Utilities: logging", "libmpc_tpu.utils.logger",
     ["Logger", "LogLevel", "LogType"]),
    ("Utilities: profiling", "libmpc_tpu.utils.profiler",
     ["Profiler", "SolutionStats"]),
    ("Utilities: deadlines", "libmpc_tpu.utils.deadline",
     ["IterationBudgeter"]),
    ("Utilities: checkpointing", "libmpc_tpu.utils.checkpoint", None),
    ("pympcxx compatibility layer", "libmpc_tpu.compat", None),
]

SKIP_METHODS = {"__init__", "__repr__", "__str__", "__eq__", "__hash__"}


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj, indent="") -> str:
    doc = inspect.getdoc(obj)
    if not doc:
        return ""
    return "\n".join(indent + line for line in doc.splitlines())


def _is_public_def(mod, name, obj):
    return (
        not name.startswith("_")
        and (inspect.isclass(obj) or inspect.isfunction(obj))
        and getattr(obj, "__module__", None) == mod.__name__
    )


def _namedtuple_fields(cls):
    if hasattr(cls, "_fields"):
        return list(cls._fields)
    if hasattr(cls, "__dataclass_fields__"):
        return list(cls.__dataclass_fields__)
    return []


def emit_class(cls, lines):
    lines.append(f"### class `{cls.__name__}{_sig(cls)}`\n")
    lines.append(_doc(cls) + "\n")
    fields = _namedtuple_fields(cls)
    if fields:
        lines.append(f"Fields: {', '.join('`%s`' % f for f in fields)}\n")
    is_enum = hasattr(cls, "__members__")
    if is_enum:
        members = ", ".join(
            f"`{k}` = {int(v)}" for k, v in cls.__members__.items()
        )
        lines.append(f"Members: {members}\n")
        return
    for name, meth in sorted(vars(cls).items()):
        if name.startswith("_"):
            continue
        if isinstance(meth, staticmethod) or isinstance(meth, classmethod):
            meth = meth.__func__
        if isinstance(meth, property):
            lines.append(f"#### property `{name}`\n")
            lines.append(_doc(meth) + "\n")
            continue
        if not callable(meth):
            continue
        lines.append(f"#### `{cls.__name__}.{name}{_sig(meth)}`\n")
        d = _doc(meth)
        if d:
            lines.append(d + "\n")


def main():
    lines = [
        "# libmpc_tpu API reference",
        "",
        "Generated from docstrings by `misc/gen_api_docs.py` — regenerate "
        "after changing any public docstring.  Parity citations "
        "(`reference: include/mpc/...`) point into the upstream libmpc++ "
        "headers this API mirrors.",
        "",
        "See also: [manual](manual.md) (formulations and solver math), "
        "[tutorial](tutorial.md) (guided walk-through), "
        "[migration guide](migration.md) (coming from libmpc++/pympcxx).",
        "",
    ]
    for title, modname, symbols in SECTIONS:
        mod = importlib.import_module(modname)
        lines.append(f"\n## {title} — `{modname}`\n")
        mod_doc = inspect.getdoc(mod)
        if mod_doc:
            lines.append(mod_doc + "\n")
        if symbols is None:
            symbols = [n for n, o in sorted(vars(mod).items())
                       if _is_public_def(mod, n, o)]
        for sym in symbols:
            obj = getattr(mod, sym)
            if inspect.isclass(obj):
                emit_class(obj, lines)
            elif callable(obj):
                lines.append(f"### `{sym}{_sig(obj)}`\n")
                lines.append(_doc(obj) + "\n")
    text = "\n".join(lines).rstrip() + "\n"
    with open(OUT, "w") as fh:
        fh.write(text)
    print(f"wrote {OUT} ({len(text.splitlines())} lines)")


if __name__ == "__main__":
    main()
