"""The port's SPMD verifier (`dsort_tpu_torch.analysis.spmd`, DS12xx/DS13xx).

Four layers, as the JAX package's test_spmd_lint.py has them:

1. Port-shaped fixtures, written here: each code caught on a bad module,
   nothing on its clean twin.
2. Seeded mutations of a copy of the port's own files: an inverted ring
   shift (in the ``torch.roll`` that is the port's ``ppermute``), a deleted
   re-pack hop, an off-grid quantum, overlapping slots of the fused ring's
   layout, a collective under a rank branch, and a deleted contract (itself
   a finding); the unmutated copy stays clean.
3. Differential: the restricted evaluator equals the port's real
   functions, which equal the JAX package's, on the bounded grids; and the
   reading "a roll by s sends row i to (i + s) % P" is what torch does.
4. The shipped contract modules pass their own proofs.
"""

import ast
import os
import shutil
from collections import Counter

import pytest
import torch

from dsort_tpu_torch.analysis import LintConfig, lint_paths, load_config
from dsort_tpu_torch.analysis.checkers.caps import CapsChecker
from dsort_tpu_torch.analysis.checkers.spmd import SpmdChecker
from dsort_tpu_torch.analysis.spmd import Evaluator, extract_functions, load_spmd_registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REGISTRY = "dsort_tpu_torch/analysis/spmd/registry.py"


def _checkers(scope=None):
    return [SpmdChecker(scope=scope), CapsChecker(scope=scope)]


def _lint_source(tmp_path, text: str, name="mod.py"):
    src = tmp_path / name
    src.write_text(text)
    return lint_paths([str(src)], LintConfig(root=REPO), checkers=_checkers(("*",)))


# -- port-shaped fixtures -------------------------------------------------------

_BAD_SPMD = '''\
import torch
import torch.distributed as dist

SPMD_CONTRACT = {
    "plane": "device",
    "perms": {
        "_shift_perm": {
            "args": ("num_workers", "k"),
            "domain": {"num_workers": "MESH", "k": "range(num_workers)"},
            "kind": "full",
            "axis_size": "num_workers",
            "dst": "(i + k) % num_workers",
        },
    },
    "rolls": {
        "ring": {"dims": 0, "axis_size": "p",
                 "domain": {"p": "MESH", "k": "range(p)"}, "dst": "(i + k) % p"},
    },
    "layouts": {"slots": {"axis": "p", "caps": "caps"}},
}


def _shift_perm(num_workers, k):
    return [(i, (i + 2 * k) % num_workers) for i in range(num_workers)]


def ring(blk, p):
    for k in range(1, p):
        blk = torch.roll(blk, p - k, dims=0)
    return torch.roll(blk, 1, dims=1)


def undeclared(blk, k):
    return torch.roll(blk, k, dims=0)


def hops(mesh, x, pairs):
    return mesh.ppermute(x, pairs)


def agree(t, mesh):
    if mesh.rank == 0:
        dist.all_reduce(t)
    rank = dist.get_rank()
    if rank > 0:
        dist.barrier()
    return t


def slots(caps):
    p = len(caps)
    buf = torch.zeros((p, sum(caps)))
    for k in range(p):
        buf[:, 0 : caps[k]] = 1
    return buf
'''

_GOOD_SPMD = '''\
import torch
import torch.distributed as dist

SPMD_CONTRACT = {
    "plane": "device",
    "perms": {
        "_shift_perm": {
            "args": ("num_workers", "k"),
            "domain": {"num_workers": "MESH", "k": "range(num_workers)"},
            "kind": "full",
            "axis_size": "num_workers",
            "dst": "(i + k) % num_workers",
        },
    },
    "rolls": {
        "ring": {"dims": 0, "axis_size": "p",
                 "domain": {"p": "MESH", "k": "range(p)"}, "dst": "(i + k) % p"},
    },
    "layouts": {"slots": {"axis": "p", "caps": "caps"}},
}


def _offsets(caps):
    offs = [0]
    for c in caps:
        offs.append(offs[-1] + c)
    return offs


def _world():
    return dist.get_rank(), dist.get_world_size()


def _shift_perm(num_workers, k):
    return [(i, (i + k) % num_workers) for i in range(num_workers)]


def ring(blk, p):
    for k in range(1, p):
        blk = torch.roll(blk, k, dims=0)
    return blk


def hops(mesh, x, k):
    perm = _shift_perm(mesh.num_workers, k)
    return mesh.ppermute(x, perm)


def agree(t):
    if _world()[1] > 1:
        dist.all_reduce(t)
    return t


def slots(caps):
    p = len(caps)
    offs = _offsets(caps)
    buf = torch.zeros((p, offs[-1]))
    for k in range(p):
        cap = caps[k]
        buf[:, offs[k] : offs[k] + cap] = 1
    return buf
'''


def test_bad_spmd_fixture_counts(tmp_path):
    diags = _lint_source(tmp_path, _BAD_SPMD)
    assert Counter(d.code for d in diags) == {"DS1201": 5, "DS1202": 2, "DS1204": 1}
    msgs = "\n".join(d.message for d in diags)
    assert "_shift_perm(num_workers=2, k=1)" in msgs        # builder off its form
    assert "torch.roll by 'p - k'" in msgs                  # inverted shift
    assert "dims=1" in msgs                                 # not the shard axis
    assert "(undeclared)" in msgs and "(hops)" in msgs      # untraced sites


def test_good_spmd_fixture_clean(tmp_path):
    assert _lint_source(tmp_path, _GOOD_SPMD) == []


def test_contract_minima_and_shape_are_loud(tmp_path):
    diags = _lint_source(tmp_path, 'SPMD_CONTRACT = {"plane": "gpu", "axis_param": "w"}\n')
    assert [d.code for d in diags] == ["DS1200", "DS1200"]
    diags = _lint_source(tmp_path, "SPMD_CONTRACT = dict(plane='host')\n")
    assert [d.code for d in diags] == ["DS1200"]


def test_host_plane_collective_flagged(tmp_path):
    diags = _lint_source(
        tmp_path,
        'SPMD_CONTRACT = {"plane": "host"}\n\n\n'
        "def f(mesh, x):\n    return mesh.all_to_all(x)\n\n\n"
        "def g(mesh, x):\n    return f(mesh, x)\n",
    )
    # f issues one; g calls f, a collective of this module.
    assert [(d.code, d.line) for d in diags] == [("DS1202", 5), ("DS1202", 9)]


_CAPS = '''\
import numpy as np

SPMD_CONTRACT = {
    "plane": "host",
    "caps": {
        "quantize": {
            "args": ("m",), "domain": {"m": "SIZES"},
            "require": (("DS1301", "out >= m"), ("DS1303", "out % 8 == 0")),
        },
        "np_quantize": {
            "args": ("m",), "domain": {"m": "SIZES"},
            "require": (("DS1301", "out >= m"),),
        },
        "lost_fn": {"args": ("m",), "domain": {"m": "SIZES"}, "require": ()},
    },
    "stores": {
        "land": ({"canvas": "rcv", "repack": "_pad_run", "width": "total"},),
    },
    "consts": {"LO": (("DS1303", "value >= 8"),)},
}
LO = 4


def quantize(m):
    return m // 8 * 8


def np_quantize(m):
    return int(np.ceil(m / 8)) * 8


def _pad_run(x, n, fill):
    return x


def land(rcv, rbuf, total, slot):
    rcv[:, slot] = rbuf
    return rcv
'''


def test_caps_fixture_counts(tmp_path):
    diags = _lint_source(tmp_path, _CAPS)
    assert Counter(d.code for d in diags) == {
        "DS1300": 2, "DS1301": 1, "DS1302": 1, "DS1303": 1,
    }
    fixed = (_CAPS.replace("return m // 8 * 8", "return -(-m // 8) * 8")
             .replace("int(np.ceil(m / 8)) * 8", "-(-m // 8) * 8")
             .replace('        "lost_fn": {"args": ("m",), "domain": {"m": "SIZES"}, '
                      '"require": ()},\n', "")
             .replace("LO = 4", "LO = 8")
             .replace("rcv[:, slot] = rbuf", "rcv[:, slot] = _pad_run(rbuf, total, 0)"))
    assert _lint_source(tmp_path, fixed) == []


# -- seeded mutations of the port's own files ----------------------------------

_TREE = (
    REGISTRY,
    "dsort_tpu_torch/parallel/exchange.py",
    "dsort_tpu_torch/parallel/distributed.py",
    "dsort_tpu_torch/ops/ring_kernel.py",
)


def _lint_copy(tmp_path, rel="dsort_tpu_torch/parallel/exchange.py", old=None, new=None):
    for f in _TREE:
        dst = tmp_path / f
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(os.path.join(REPO, f), dst)
    target = tmp_path / rel
    if old is not None:
        text = target.read_text()
        assert old in text, f"mutation anchor drifted: {old!r}"
        target.write_text(text.replace(old, new, 1))
    return lint_paths([str(target)], load_config(str(tmp_path)), checkers=_checkers())


@pytest.mark.parametrize("rel", [
    "dsort_tpu_torch/parallel/exchange.py",
    "dsort_tpu_torch/parallel/distributed.py",
    "dsort_tpu_torch/ops/ring_kernel.py",
])
def test_clean_copy_has_no_findings(tmp_path, rel):
    assert _lint_copy(tmp_path, rel) == []


@pytest.mark.parametrize("old,new,where", [
    ("recv_k = torch.roll(blk, k, dims=0)", "recv_k = torch.roll(blk, -k, dims=0)",
     "_ring_exchange_kv_shard"),
    ("torch.roll(x.reshape((-1, p) + x.shape[1:]), k, dims=1)",
     "torch.roll(x.reshape((-1, p) + x.shape[1:]), p - k, dims=1)", "_roll_jobs"),
    ("torch.roll(blk, (k + j) % p, dims=0)", "torch.roll(blk, (k - j) % p, dims=0)",
     "_coded_ring_exchange_shard"),
    ("(i // d) * d + ((i % d + k) % d)", "(i // d) * d + ((i % d - k) % d)",
     "_hier_perm_intra"),
], ids=["kv-roll", "roll-jobs", "coded-replica", "hier-intra"])
def test_mutation_inverted_ring_shift_is_caught(tmp_path, old, new, where):
    diags = _lint_copy(tmp_path, old=old, new=new)
    assert {d.code for d in diags} == {"DS1201"}
    assert all(where in d.message for d in diags)


def test_mutation_deleted_repack_hop_is_caught(tmp_path):
    diags = _lint_copy(tmp_path, old="_pad_run(rbuf, agg_total, sent)", new="rbuf")
    assert [d.code for d in diags] == ["DS1302"]
    assert "_hier_exchange_shard" in diags[0].message


def test_mutation_offgrid_quantum_is_caught(tmp_path):
    diags = _lint_copy(
        tmp_path,
        old="return max(-(-max(n_local // (8 * num_workers), 8) // 8) * 8, 8)",
        new="return max(n_local // (8 * num_workers), 12)",
    )
    assert "DS1303" in {d.code for d in diags}
    assert any("ring_step_quantum" in d.message for d in diags)


def test_deleted_contract_is_itself_a_finding(tmp_path):
    diags = _lint_copy(tmp_path, old="SPMD_CONTRACT = {", new="SPMD_CONTRACT_DISABLED = {")
    assert "DS1200" in {d.code for d in diags}


@pytest.mark.parametrize("old,new", [
    ("wv[:, offs[k] : offs[k] + cap] =", "wv[:, offs[k] : offs[k] + cap + 8] ="),
    ("wk[:, k, :cap] = torch.where", "wk[:, k // 2, :cap] = torch.where"),
], ids=["payload-slot-overrun", "key-slot-collision"])
def test_mutation_overlapping_ring_slots_is_caught(tmp_path, old, new):
    diags = _lint_copy(tmp_path, "dsort_tpu_torch/ops/ring_kernel.py", old, new)
    assert [d.code for d in diags] == ["DS1204"]
    assert "ring_exchange_plain" in diags[0].message


def test_mutation_collective_under_a_rank_branch_is_caught(tmp_path):
    diags = _lint_copy(
        tmp_path, "dsort_tpu_torch/parallel/distributed.py",
        "    if _rank_world()[1] > 1:\n        _dist().barrier()",
        "    if _rank_world()[0] > 0:\n        _dist().barrier()",
    )
    assert [d.code for d in diags] == ["DS1202"]
    assert "_mh_sync" in diags[0].message


def test_required_modules_cover_the_process_group_plane():
    reg = load_spmd_registry(os.path.join(REPO, REGISTRY))
    assert "dsort_tpu_torch/parallel/distributed.py" in reg["SPMD_REQUIRED"]
    for rel in reg["SPMD_REQUIRED"]:
        assert os.path.exists(os.path.join(REPO, rel)), rel


def test_shipped_contract_modules_pass_their_proofs():
    reg = load_spmd_registry(os.path.join(REPO, REGISTRY))
    paths = [os.path.join(REPO, rel) for rel in reg["SPMD_REQUIRED"]]
    assert lint_paths(paths, load_config(REPO), checkers=_checkers()) == []


# -- differential: the evaluator, the port's functions, the reference's --------


def _evaluator(rel):
    with open(os.path.join(REPO, rel), encoding="utf-8") as f:
        return Evaluator(extract_functions(ast.parse(f.read())))


def test_symeval_matches_the_real_functions_and_the_reference():
    from dsort_tpu.parallel import exchange as jex
    from dsort_tpu_torch.models.pipelines import pad_rung
    from dsort_tpu_torch.ops.ring_kernel import _step_offsets
    from dsort_tpu_torch.parallel import exchange as real

    ev = _evaluator("dsort_tpu_torch/parallel/exchange.py")
    for p in (1, 2, 3, 4, 6, 8):
        for n in (8, 100, 4096):
            assert ev.call("ring_step_quantum", [n, p]) == real.ring_step_quantum(n, p) \
                == jex.ring_step_quantum(n, p)
            for m in (0, 1, n // 2, n):
                assert ev.call("_quantize_cap", [m, n, p]) == real._quantize_cap(m, n, p) \
                    == jex._quantize_cap(m, n, p)
        for r in (None, 1, 2, 3, 9):
            assert ev.call("resolve_redundancy", [r, 2, p]) == \
                real.resolve_redundancy(r, 2, p) == jex.resolve_redundancy(r, 2, p)
        for d in (x for x in range(1, p + 1) if p % x == 0):
            for k in range(d):
                assert ev.call("_hier_perm_intra", [p, d, k]) == \
                    real._hier_perm_intra(p, d, k) == jex._hier_perm_intra(p, d, k)
            for s in range(p // d):
                h = p // d
                assert ev.call("_hier_perm_leg", [p, h, s]) == \
                    real._hier_perm_leg(p, h, s) == jex._hier_perm_leg(p, h, s)
    for hi in (8, 100, 4096):
        assert ev.call("ladder_rungs", [hi, 8]) == real.ladder_rungs(hi, 8)
    for r in range(1, 6):
        assert ev.call("parity_slots", [r]) == real.parity_slots(r) == jex.parity_slots(r)
    pev = _evaluator("dsort_tpu_torch/models/pipelines.py")
    for n in (1, 7, 8, 9, 1000, 4097, (1 << 20) - 3):
        assert pev.call("pad_rung", [n]) == pad_rung(n)
    rev = _evaluator("dsort_tpu_torch/ops/ring_kernel.py")
    for caps in ((8,), (8, 0, 16), (16, 8, 8, 32)):
        assert rev.call("_step_offsets", [caps]) == _step_offsets(caps)


@pytest.mark.parametrize("p", [1, 2, 3, 8])
def test_a_roll_is_the_declared_ring_permutation(p):
    """The reading behind DS1201's rolls: ``torch.roll`` by ``s`` along the
    shard axis sends row ``i`` to ``(i + s) % P`` — the reference's
    ``ppermute`` by ``_ring_perm(P, s)`` — and `_roll_jobs` does so inside
    each job of ``J*P`` rows."""
    from dsort_tpu.parallel.exchange import _ring_perm
    from dsort_tpu_torch.parallel.exchange import _roll_jobs

    rows = torch.arange(p)
    for k in range(p):
        out = torch.roll(rows, k, dims=0)
        assert {(int(out[dst]), dst) for dst in range(p)} == set(_ring_perm(p, k))
        jobs = torch.arange(3 * p).reshape(3 * p, 1)
        got = _roll_jobs(jobs, k, p).reshape(3, p)
        for src, dst in _ring_perm(p, k):
            assert (got[:, dst] == torch.arange(3) * p + src).all()
