"""The port's torch lint against the JAX package's jaxlint.

Every fixture of ``tests/test_analysis.py``'s ``TestLint*`` classes and
``scripts/lint_jax.py``'s clock fixtures whose rule has a torch
counterpart is translated line for line (``@jax.jit`` becomes
``@torch.compile``, a ``pure_callback`` target a ``torch.compiler.
disable`` one, ``jnp`` calls ``torch`` calls), and the two lints must
give the same ``(rule, line)`` findings.  ``cond-structure`` and
``jit-no-donate`` have no torch counterpart (eager ``if`` has no branch
structure; eager torch has no donation).  Then the torch-only forms of
each rule, the package sweep (clean, every deliberate site under a
reasoned pragma), and the CLI (``--check`` run by path imports no
torch).
"""
from __future__ import annotations

import os
import subprocess
import sys

import pytest

from kfac_pytorch_tpu.analysis import lint as jax_lint
from kfac_pytorch_tpu_torch.analysis import collective
from kfac_pytorch_tpu_torch.analysis import lint

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, 'kfac_pytorch_tpu_torch', 'scripts',
                      'lint_torch.py')

#: (name, JAX source, torch source): one fixture of each JAX test.
FIXTURES = [
    ('item in traced',
     'import jax\n@jax.jit\ndef f(x):\n    return x.item()\n',
     'import torch\n@torch.compile\ndef f(x):\n    return x.item()\n'),
    ('float of device value',
     'import jax, jax.numpy as jnp\n@jax.jit\ndef f(x):\n'
     '    s = jnp.sum(x)\n    return float(s)\n',
     'import torch\n@torch.compile\ndef f(x):\n'
     '    s = torch.sum(x)\n    return float(s)\n'),
    ('host materialization in traced',
     'import jax\nimport numpy as np\n@jax.jit\ndef f(x):\n'
     '    return np.asarray(x)\n',
     'import torch\nimport numpy as np\n@torch.compile\ndef f(x):\n'
     '    return x.numpy()\n'),
    ('float of array-annotated param',
     'import jax\nfrom jax import Array\n@jax.jit\ndef f(x: Array):\n'
     '    return x * float(x)\n',
     'import torch\nfrom torch import Tensor\n@torch.compile\n'
     'def f(x: Tensor):\n    return x * float(x)\n'),
    ('float of host-annotated param',
     'import jax\n@jax.jit\ndef f(x, norm: float):\n'
     '    return x * float(norm)\n',
     'import torch\n@torch.compile\ndef f(x, norm: float):\n'
     '    return x * float(norm)\n'),
    ('shape arithmetic',
     'import jax, jax.numpy as jnp\n@jax.jit\ndef f(x):\n'
     '    n = float(x.shape[0])\n    kh = int(x.shape[1])\n'
     '    return jnp.sum(x) / (n * kh)\n',
     'import torch\n@torch.compile\ndef f(x):\n'
     '    n = float(x.shape[0])\n    kh = int(x.shape[1])\n'
     '    return torch.sum(x) / (n * kh)\n'),
    ('host function',
     'def report(arr):\n    return float(arr.sum())\n',
     'def report(arr):\n    return float(arr.sum())\n'),
    ('host callback exempt',
     'import jax\nimport numpy as np\ndef _eig_host(a):\n'
     '    return np.asarray(np.linalg.eig(a)[0])\n@jax.jit\ndef f(a):\n'
     '    return jax.pure_callback(_eig_host, a, a)\n',
     'import torch\nimport numpy as np\ndef _eig_host(a):\n'
     '    return a.numpy()\n@torch.compile\ndef f(a):\n'
     '    return torch.compiler.disable(_eig_host)(a)\n'),
    ('factory function',
     'import jax, jax.numpy as jnp\ndef build():\n    def body(x):\n'
     '        return x.item()\n    return body\nfn = jax.jit(build())\n',
     'import torch\ndef build():\n    def body(x):\n'
     '        return x.item()\n    return body\n'
     'fn = torch.compile(build())\n'),
    ('float literal',
     'import jax.numpy as jnp\nd = jnp.asarray(0.001)\n',
     'import torch\nd = torch.tensor(0.001)\n'),
    ('hyperparameter name',
     'import jax.numpy as jnp\ndef hp(damping):\n'
     '    return jnp.asarray(damping)\n',
     'import torch\ndef hp(damping):\n    return torch.as_tensor(damping)\n'),
    ('explicit dtype',
     'import jax.numpy as jnp\nd = jnp.asarray(0.001, jnp.float32)\n'
     'e = jnp.asarray(0.001, dtype=jnp.float32)\n',
     'import torch\nd = torch.as_tensor(0.001, torch.float32)\n'
     'e = torch.tensor(0.001, dtype=torch.float32)\n'),
    ('non-hyperparameter array',
     'import jax.numpy as jnp\ndef f(mask):\n    return jnp.asarray(mask)\n',
     'import torch\ndef f(mask):\n    return torch.as_tensor(mask)\n'),
    ('time in traced',
     'import jax, time\n@jax.jit\ndef f(x):\n    return x * time.time()\n',
     'import torch, time\n@torch.compile\ndef f(x):\n'
     '    return x * time.time()\n'),
    ('np.random in traced',
     'import jax\nimport numpy as np\n@jax.jit\ndef f(x):\n'
     '    return x + np.random.rand()\n',
     'import torch\nimport numpy as np\n@torch.compile\ndef f(x):\n'
     '    return x + np.random.rand()\n'),
    ('time on host',
     'import time\ndef timed(fn):\n    t0 = time.perf_counter()\n'
     '    out = fn()\n    return out, time.perf_counter() - t0\n',
     'import time\ndef timed(fn):\n    t0 = time.perf_counter()\n'
     '    out = fn()\n    return out, time.perf_counter() - t0\n'),
    ('f64 astype in traced',
     'import jax\nimport jax.numpy as jnp\n@jax.jit\ndef f(x):\n'
     '    return x.astype(jnp.float64)\n',
     'import torch\nimport numpy as np\n@torch.compile\ndef f(x):\n'
     '    return x.to(torch.float64)\n'),
    ('f64 dtype keyword',
     'import jax\nimport jax.numpy as jnp\n@jax.jit\ndef f(x):\n'
     "    return x + jnp.zeros((3,), dtype='float64')\n",
     'import torch\nimport numpy as np\n@torch.compile\ndef f(x):\n'
     '    return x + torch.zeros((3,), dtype=torch.float64)\n'),
    ('np.float64 literal',
     'import jax\nimport numpy as np\n@jax.jit\ndef f(x):\n'
     '    return x * np.float64(0.5)\n',
     'import torch\nimport numpy as np\n@torch.compile\ndef f(x):\n'
     '    return x * np.float64(0.5)\n'),
    ('f32 and host f64',
     'import jax\nimport jax.numpy as jnp\nimport numpy as np\n@jax.jit\n'
     'def f(x):\n    return x.astype(jnp.float32)\ndef host_stats(arr):\n'
     '    return np.asarray(arr, dtype=np.float64).sum()\n',
     'import torch\nimport numpy as np\nimport numpy\n@torch.compile\n'
     'def f(x):\n    return x.to(torch.float32)\ndef host_stats(arr):\n'
     '    return np.asarray(arr, dtype=np.float64).sum()\n'),
    ('f64 pragma',
     'import jax\nimport jax.numpy as jnp\n@jax.jit\ndef f(x):\n'
     '    return x.astype(jnp.float64)  # jaxlint: allow(f64-promotion)\n',
     'import torch\nimport numpy as np\n@torch.compile\ndef f(x):\n'
     '    return x.double()  # torchlint: allow(f64-promotion) a reason\n'),
    ('same-line pragma',
     'import jax\n@jax.jit\ndef f(x):\n'
     '    return x.item()  # jaxlint: allow(host-sync)\n',
     'import torch\n@torch.compile\ndef f(x):\n'
     '    return x.item()  # torchlint: allow(host-sync) a reason\n'),
    ('def-line pragma',
     'import jax\n@jax.jit\ndef f(x):  # jaxlint: allow(host-sync)\n'
     '    return x.item()\n',
     'import torch\n@torch.compile\n'
     'def f(x):  # torchlint: allow(host-sync) a reason\n'
     '    return x.item()\n'),
    ('pragma for another rule',
     'import jax\n@jax.jit\ndef f(x):\n'
     '    return x.item()  # jaxlint: allow(weak-literal)\n',
     'import torch\n@torch.compile\ndef f(x):\n'
     '    return x.item()  # torchlint: allow(weak-literal)\n'),
    # scripts/lint_jax.py's clock fixtures.
    ('clock feeds collective digest',
     '\nimport time\nimport jax.numpy as jnp\ndef host_sync(x):\n'
     '    stamp = time.time()\n    y = jnp.full((), stamp)\n'
     '    return process_allgather(y)\n',
     '\nimport time\nimport torch\ndef host_sync(x):\n'
     '    stamp = time.time()\n    y = torch.full((), stamp)\n'
     '    return all_gather_object(y)\n'),
    ('clock is timing-only',
     '\nimport time\ndef host_sync(x):\n    t0 = time.monotonic()\n'
     '    out = process_allgather(x)\n    print(time.monotonic() - t0)\n'
     '    return out\n',
     '\nimport time\ndef host_sync(x):\n    t0 = time.monotonic()\n'
     '    out = all_gather_object(x)\n    print(time.monotonic() - t0)\n'
     '    return out\n'),
    ('clock without a collective nearby',
     '\nimport time\nimport jax.numpy as jnp\ndef stamp_only(x):\n'
     '    stamp = time.time()\n    return jnp.full((), stamp)\n',
     '\nimport time\nimport torch\ndef stamp_only(x):\n'
     '    stamp = time.time()\n    return torch.full((), stamp)\n'),
]


def findings(module, src):
    return [(f.rule, f.line) for f in module.lint_source(src)]


@pytest.mark.parametrize('name,jax_src,torch_src', FIXTURES,
                         ids=[f[0] for f in FIXTURES])
def test_translated_fixture_gives_jaxs_rule_and_line(name, jax_src,
                                                     torch_src):
    assert findings(lint, torch_src) == findings(jax_lint, jax_src)


def test_fixtures_cover_every_shared_rule():
    flagged = {r for _, j, _ in FIXTURES for r, _ in findings(jax_lint, j)}
    assert flagged == set(lint.RULES)
    assert set(lint.RULES) == set(jax_lint.RULES) - {
        'cond-structure', 'jit-no-donate', 'unsharded-stack'}


#: The torch-only forms of each rule: (name, source, findings).
TORCH_FORMS = [
    ('cpu of a tensor', 'import torch\n@torch.compile\ndef f(x):\n'
     '    return x.sum().cpu()\n', [('host-sync', 4)]),
    ('tolist of numpy is host', 'import numpy as np\nimport torch\n'
     '@torch.compile\ndef f(x):\n    m = np.zeros(3)\n'
     '    return m.tolist()\n', []),
    ('nonzero', 'import torch\n@torch.compile\ndef f(x):\n'
     '    return torch.nonzero(x), x.nonzero()\n',
     [('host-sync', 4), ('host-sync', 4)]),
    ('synchronize', 'import torch\n@torch.compile\ndef f(x):\n'
     '    torch.cuda.synchronize()\n    return x\n', [('host-sync', 4)]),
    ('metadata is host', 'import torch\n@torch.compile\ndef f(x):\n'
     '    return int(x.numel()) + float(torch.finfo(x.dtype).eps)\n', []),
    ('randn without generator', 'import torch\n@torch.compile\ndef f(x):\n'
     '    return x + torch.randn(3)\n', [('nondeterminism', 4)]),
    ('randn with generator', 'import torch\n@torch.compile\ndef f(x, g):\n'
     '    return x + torch.randn(3, generator=g)\n', []),
    ('in-place normal_', 'import torch\n@torch.compile\ndef f(x):\n'
     '    return x.normal_()\n', [('nondeterminism', 4)]),
    ('double', 'import torch\n@torch.compile\ndef f(x):\n'
     '    return x[0].double()\n', [('f64-promotion', 4)]),
    ('hot stage method by name', 'class E:\n    def _precondition(self):\n'
     '        return self._helper()\n    def _helper(self):\n'
     '        return self.t.item()\n', [('host-sync', 5)]),
    ('ops module numerics', None, [('host-sync', 2)]),
    ('a called parameter is not the module function of its name',
     'class E:\n    def _step(self, run):\n        return run()\n'
     'def run(t):\n    return t.item()\n', []),
]


@pytest.mark.parametrize('name,src,want', TORCH_FORMS,
                         ids=[f[0] for f in TORCH_FORMS])
def test_torch_forms(name, src, want):
    if src is None:  # a top-level function of an ops/ module is hot
        got = [(f.rule, f.line) for f in lint.lint_source(
            'def f(x):\n    return x.tolist()\n', 'pkg/ops/m.py',
            all_hot=True)]
    else:
        got = findings(lint, src)
    assert got == want


def test_package_sweeps_clean():
    out = lint.lint_paths([os.path.join(ROOT, 'kfac_pytorch_tpu_torch')])
    assert out == [], '\n'.join(f.format() for f in out)


def test_every_deliberate_site_carries_a_reasoned_pragma():
    """Each ``# torchlint: allow(...)`` in the package is a deliberate
    finding: removing the pragmas brings each back, and each sits under
    (or beside) a comment that says why."""
    port = os.path.join(ROOT, 'kfac_pytorch_tpu_torch')
    sites = []
    for dirpath, _, files in os.walk(port):
        for fn in files:
            # The lint and its CLI name the pragma in their text.
            if (not fn.endswith('.py') or dirpath.endswith('analysis')
                    or fn == 'lint_torch.py'):
                continue
            path = os.path.join(dirpath, fn)
            with open(path, encoding='utf-8') as fh:
                lines = fh.read().splitlines()
            hits = [i for i, line in enumerate(lines)
                    if lint.PRAGMA_RE.search(line)]
            if not hits:
                continue
            stripped = '\n'.join(lint.PRAGMA_RE.sub('', line)
                                 for line in lines)
            rel = os.path.relpath(path, ROOT)
            found = lint.lint_source(
                stripped, rel, all_hot=bool(lint.ALL_HOT_PATH_RE.search(rel)))
            flagged = ({f.line - 1 for f in found}
                       | {f.func_line - 1 for f in found if f.func_line})
            assert flagged >= set(hits), rel
            for i in hits:
                context = lines[max(0, i - 3):i + 1]
                assert any(line.strip().startswith('#') for line in context), (
                    f'{rel}:{i + 1}')
            sites.extend((rel, i + 1) for i in hits)
    assert len(sites) >= 8


def test_collective_registry_mirror():
    assert lint.DEFAULT_COLLECTIVE_NAMES == collective.COLLECTIVE_NAMES


def test_check_by_path_imports_no_torch():
    code = (
        'import runpy, sys\n'
        f'sys.argv = ["lint_torch.py", "--check", {ROOT!r} + '
        '"/kfac_pytorch_tpu_torch"]\n'
        'try:\n'
        f'    runpy.run_path({SCRIPT!r}, run_name="__main__")\n'
        'except SystemExit as e:\n'
        '    rc = e.code\n'
        'bad = sorted(n for n in sys.modules if n.split(".")[0] in\n'
        '             ("torch", "kfac_pytorch_tpu_torch", "jax"))\n'
        'print(rc, bad)\n'
        'sys.exit(rc or bool(bad))\n'
    )
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert 'torchlint: clean' in out.stdout


def test_check_flags_a_finding_with_exit_1(tmp_path):
    bad = tmp_path / 'bad.py'
    bad.write_text('import torch\n@torch.compile\ndef f(x):\n'
                   '    return x.item()\n')
    out = subprocess.run([sys.executable, SCRIPT, '--check', str(bad)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 1
    assert 'bad.py:4:11: [host-sync]' in out.stdout


def test_list_rules_and_spmd_modes():
    from kfac_pytorch_tpu_torch.scripts import lint_torch

    assert lint_torch.main(['--list-rules']) == 0
    assert lint_torch.main(['--spmd']) == 0
