"""Execute every Python code block of docs/tutorial.md.

The reference ships its tutorial as an *executed* Quarto notebook
(``reference tutorial.qmd`` + ``_quarto.yml``), so documented examples
cannot silently rot.  This test gives docs/tutorial.md the same property:
all ```python blocks run sequentially in one shared namespace, notebook
style.

Two deviations from verbatim execution, both mechanical and listed here:

1. **Size substitutions** (the table below): lattice sizes, expansion
   orders, and sample counts are shrunk so the whole tutorial executes in
   CI time on the 8-virtual-device CPU backend.  The *code paths* are
   identical — only problem sizes change.  Sizes divisible by 8 are used
   where sharding blocks need the virtual mesh.
2. **Demo-variable prelude**: a few snippets reference illustrative
   variables (``site``, ``energies``, ``v``, ``delta`` …) whose
   construction the prose describes; `_ensure_demo_names` defines them
   the way the surrounding text specifies.

Any other failure — renamed API, changed signature, broken import,
physics assertion inside a block — fails this test.
"""

import re

import numpy as np
import pytest

TUTORIAL = "docs/tutorial.md"

# (pattern, replacement) applied verbatim to each block, most-specific
# first.  Only sizes/orders/coordinates — never API names.
SUBSTITUTIONS = [
    ("CubicLattice((32, 32, 1))", "CubicLattice((16, 16, 1))"),
    ("CubicLattice((64, 64, 1))", "CubicLattice((16, 16, 1))"),
    ("CubicLattice((24, 24, 1))", "CubicLattice((16, 16, 1))"),
    ("swave_superconductor((64, 64, 1)", "swave_superconductor((16, 16, 1)"),
    ("(16, 16, 0)", "(8, 8, 0)"),
    ("(32, 32, 0)", "(8, 8, 0)"),
    ("(16, y, 0)", "(8, y, 0)"),
    ("in (8, 16, 24)", "in (4, 8, 12)"),
    ("x >= 20", "x >= 12"),
    ("np.pi * ci[:, 0] / 64", "np.pi * ci[:, 0] / 16"),
    ("L=128, phase=φ, delta0=3.0, leads=32", "L=32, phase=φ, delta0=3.0, leads=8"),
    ("order=2048", "order=128"),
    ("order=1024", "order=128"),
    ("order=512", "order=64"),
    ("samples=64", "samples=4"),
    # solve_gap: cap the gradient-descent steps for CI.
    ("temperature=0.0, uniform=True,", "temperature=0.0, uniform=True, steps=25,"),
    ("steps=150,", "steps=6,"),
    # Keep the KPM objectives' sweeps short.
    ('temperature=0.05, method="kpm")', 'temperature=0.05, method="kpm", order=32, samples=4)'),
    ('method="kpm", mesh=mesh)', 'method="kpm", mesh=mesh, order=32, samples=4)'),
]


def _blocks():
    text = open(TUTORIAL).read()
    blocks = re.findall(r"```python\n(.*?)```", text, re.S)
    assert blocks, "tutorial has no python blocks?"
    out = []
    for b in blocks:
        for pat, rep in SUBSTITUTIONS:
            b = b.replace(pat, rep)
        out.append(b)
    return out


def _ensure_demo_names(ns):
    """Define illustrative free variables the prose introduces informally."""
    ns.setdefault("site", (8, 8, 0))
    if "energies" not in ns:
        ns["energies"] = np.linspace(-1.0, 1.0, 21)
    system = ns.get("system")
    if system is not None:
        N = system.lattice.size
        dt = system.dtype
        if "v" not in ns:
            ns["v"] = np.ones((N, 4, 2), dt)
        if "v0" not in ns:
            ns["v0"] = np.ones((N, 4, 4), dt)
        if "delta" not in ns:
            ns["delta"] = np.full((N,), 0.1, dt)


@pytest.mark.slow
def test_tutorial_blocks_execute():
    ns = {}
    for i, block in enumerate(_blocks()):
        _ensure_demo_names(ns)
        try:
            exec(compile(block, f"{TUTORIAL}[block {i}]", "exec"), ns)
        except Exception as e:  # pragma: no cover - failure reporting
            pytest.fail(
                f"tutorial block {i} failed: {type(e).__name__}: {e}\n"
                f"--- block source (after size substitutions) ---\n{block}"
            )
