"""Documentation build (the reference ships a Documenter.jl build,
sph_jl/docs/make.jl: API pages from docstrings + example pages generated
from the example scripts via Literate). This is the Python analogue: it
introspects the package and writes

  docs/api/<module>.md   — signatures + docstrings of the public surface
  docs/examples.md       — one section per model module (the reference's
                           generated example pages)

Run ``python docs/make.py`` from the repo root; output is checked in so the
docs are readable without a build step.
"""
from __future__ import annotations

import importlib
import inspect
import os
import pkgutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PACKAGE = "sph_mountain_waves_tpu"

CORE_MODULES = [
    "algebra", "structs", "kernels", "grids", "geometry", "io",
    "ops.apply", "ops.neighbors", "ops.solvers", "ops.mg",
    "ops.pallas_pairs", "ops.kernel_parity",
    "parallel.domain", "parallel.bucket", "parallel.run",
    "utils.packing", "utils.fixpa", "utils.entropy", "utils.icr",
    "utils.checkpoint", "utils.metrics", "utils.rkpm", "utils.plots",
]


def _doc(obj) -> str:
    d = inspect.getdoc(obj)
    return d if d else "*(undocumented)*"


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _public_members(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    out = []
    for n in names:
        obj = getattr(mod, n, None)
        if obj is None or inspect.ismodule(obj):
            continue
        if getattr(obj, "__module__", None) != mod.__name__:
            continue  # re-exports are documented at their home module
        if inspect.isclass(obj) or inspect.isfunction(obj):
            out.append((n, obj))
    return out


def render_module(modname: str) -> str:
    mod = importlib.import_module(f"{PACKAGE}.{modname}")
    lines = [f"# `{PACKAGE}.{modname}`", ""]
    lines += [_doc(mod), ""]
    for name, obj in _public_members(mod):
        if inspect.isclass(obj):
            lines += [f"## class `{name}`", "", _doc(obj), ""]
            for mname, meth in inspect.getmembers(obj):
                if mname.startswith("_") or not callable(meth):
                    continue
                if not (inspect.isfunction(meth) or inspect.ismethod(meth)):
                    continue
                if meth.__qualname__.split(".")[0] != obj.__name__:
                    continue  # inherited
                lines += [f"### `{name}.{mname}{_sig(meth)}`", "",
                          _doc(meth), ""]
        else:
            lines += [f"## `{name}{_sig(obj)}`", "", _doc(obj), ""]
    return "\n".join(lines) + "\n"


def render_examples() -> str:
    models_pkg = importlib.import_module(f"{PACKAGE}.models")
    lines = ["# Simulation models", "",
             "One section per model module (the reference's Documenter build "
             "generates one page per example script, sph_jl/docs/make.jl:20-33"
             "). Every model exposes `run(cfg, out_path=None, verbose=False)` "
             "returning a dict of diagnostic time series, and writes "
             "PVD/VTP + `data.csv` artifacts when `out_path` is given.", ""]
    names = sorted(m.name for m in pkgutil.iter_modules(models_pkg.__path__)
                   if m.name not in ("common",))
    for name in names:
        mod = importlib.import_module(f"{PACKAGE}.models.{name}")
        lines += [f"## `{name}`", "", _doc(mod), ""]
    return "\n".join(lines) + "\n"


def main():
    api_dir = os.path.join(ROOT, "docs", "api")
    os.makedirs(api_dir, exist_ok=True)
    index = ["# API reference", "",
             "Generated by `python docs/make.py` (the analogue of the "
             "reference's Documenter build, sph_jl/docs/make.jl).", ""]
    for modname in CORE_MODULES:
        fname = modname.replace(".", "_") + ".md"
        with open(os.path.join(api_dir, fname), "w") as f:
            f.write(render_module(modname))
        index.append(f"- [`{PACKAGE}.{modname}`](api/{fname})")
        print("wrote", fname)
    index.append("- [Simulation models](examples.md)")
    with open(os.path.join(ROOT, "docs", "index.md"), "w") as f:
        f.write("\n".join(index) + "\n")
    with open(os.path.join(ROOT, "docs", "examples.md"), "w") as f:
        f.write(render_examples())
    print("wrote index.md, examples.md")


if __name__ == "__main__":
    main()
