"""The import guard: nothing ``run.py`` can reach imports JAX, jaxlib,
flax or the JAX package, with top-level names compared whole; the
reference and the frozen copies import nothing of the port either."""
import ast
import os

from port_bench import harness

BENCH = harness.HERE
NEVER = {'jax', 'jaxlib', 'flax', 'larndsim_tpu'}
PORT = 'larndsim_tpu_torch'
#: files that run no part of the benchmark
SKIP = ('tests',)


def _modules():
    for base, dirs, files in os.walk(BENCH):
        rel = os.path.relpath(base, BENCH)
        if rel.split(os.sep)[0] in SKIP:
            continue
        for name in files:
            if name.endswith('.py'):
                yield os.path.join(base, name)


def _top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


def test_no_jax_anywhere_the_benchmark_runs():
    paths = list(_modules())
    assert any(p.endswith('run.py') for p in paths)
    for path in paths:
        found = set(_top_level_imports(path)) & NEVER
        assert not found, (path, found)


def test_the_reference_imports_nothing_of_the_port():
    roots = [os.path.join(BENCH, d) for d in ('reference', 'compare')] + [
        os.path.join(BENCH, f) for f in ('traffic.py', 'costs.py',
                                         'check.py', 'assets.py')]
    checked = 0
    for path in _modules():
        if not any(path == r or path.startswith(r + os.sep) for r in roots):
            continue
        checked += 1
        found = set(_top_level_imports(path)) & (NEVER | {PORT})
        assert not found, (path, found)
    assert checked > 15


def test_whole_names_are_compared():
    assert 'larndsim_tpu_torch'.split('.')[0] not in NEVER
    assert 'larndsim_tpu.ops'.split('.')[0] in NEVER
    assert harness.forbidden_modules() == [] or all(
        n.split('.')[0] in harness.FORBIDDEN
        for n in harness.forbidden_modules())
