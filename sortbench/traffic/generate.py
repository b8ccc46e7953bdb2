"""The one generator of every traffic mix: a pool of job inputs from a seed.

A mix's file names a ``distribution`` and its parameters; the
configuration gives the job size and the key type.  The distributions are
those of ``dsort_tpu_torch/data/ingest.py``'s generators:

- ``uniform``: keys uniform over the key type's range, its maximum
  excluded (`gen_uniform`);
- ``zipf``: zipf(``a``) keys, clipped (not wrapped) into the key type
  (`gen_zipf`);
- ``terasort``: records of ``key_bytes + value_bytes`` uniform random
  bytes (`gen_terasort`), handed over as `read_terasort_file` hands them:
  the first 8 key bytes packed big-endian into a uint64 key, the other
  bytes a contiguous ``(n, 92)`` uint8 payload.  With
  ``records_per_prefix`` the first 8 key bytes of each record are one of
  ``n / records_per_prefix`` random prefixes, so records share them and
  key bytes 8-9 decide their order.

They are drawn on the card by a seeded ``torch.Generator`` in a few large
calls and copied once to host arrays, which is what a user hands the
sorter: NumPy's own zipf sampler takes some 15 s for 2^26 keys on one host
core, and every run pays its set-up.  Zipf is drawn by inverting its
distribution: an exact table up to ``ZIPF_TABLE`` and the integral bound
of the tail beyond it.  Input ``i`` of the pool takes its own seed,
derived from ``(seed, i)``, so every seed gives the same sizes.
"""

from __future__ import annotations

import numpy as np

ZIPF_TABLE = 4096


def input_seed(seed: int, i: int) -> int:
    """The generator seed of pool input ``i`` (any whole ``seed``)."""
    return int(np.random.SeedSequence([seed % 2**64, i]).generate_state(1, np.uint64)[0])


def zeta(a: float, terms: int = 10**6) -> float:
    """Riemann zeta at ``a > 1``: the first ``terms`` terms plus the
    Euler-Maclaurin tail (error far below float64's resolution here)."""
    k = np.arange(1, terms + 1, dtype=np.float64)
    n = float(terms)
    return float((k ** -a).sum() + n ** (1 - a) / (a - 1) - n ** -a / 2 + a * n ** (-a - 1) / 12)


def _zipf(n: int, a: float, dtype, device, gen):
    import torch

    z = zeta(a)
    ks = np.arange(1, ZIPF_TABLE + 1, dtype=np.float64)
    cdf = torch.from_numpy(np.cumsum(ks ** -a) / z).to(device)
    u = torch.rand(n, dtype=torch.float64, device=device, generator=gen)
    k = (torch.searchsorted(cdf, u) + 1).to(torch.float64)
    # Tail: P(X >= k) ~ (k - 1/2)^(1-a) / ((a-1) zeta), inverted.
    tail = ((1 - u) * ((a - 1) * z)) ** (1 / (1 - a))
    k = torch.where(u > cdf[-1], torch.floor(tail + 0.5), k)
    top = np.iinfo(dtype).max
    out = k.clamp(max=float(2**62)).to(torch.int64)
    out = torch.where(k >= float(top), torch.full_like(out, top), out)
    return out.to(_torch_dtype(dtype))


def _torch_dtype(dtype):
    import torch

    return torch.from_numpy(np.empty(0, dtype)).dtype


def _keys(traffic: dict, n: int, dtype, device, gen):
    import torch

    dist = traffic["distribution"]
    if dist == "uniform":
        info = np.iinfo(dtype)
        return torch.randint(int(info.min), int(info.max), (n,), dtype=_torch_dtype(dtype),
                             device=device, generator=gen)
    if dist == "zipf":
        return _zipf(n, float(traffic["a"]), dtype, device, gen)
    raise ValueError(f"unknown key distribution {dist!r}")


def _records(traffic: dict, config: dict, n: int, device, gen):
    import torch

    width = int(config["key_bytes"]) + int(config["value_bytes"])
    raw = torch.randint(0, 256, (n, width), dtype=torch.uint8, device=device, generator=gen)
    per_prefix = int(traffic.get("records_per_prefix", 0))
    if per_prefix:
        # Each record's first 8 key bytes are one of n / per_prefix random
        # prefixes, picked uniformly; the other bytes stay uniform.
        prefixes = max(1, n // per_prefix)
        table = torch.randint(0, 256, (prefixes, 8), dtype=torch.uint8, device=device, generator=gen)
        pick = torch.randint(0, prefixes, (n,), device=device, generator=gen)
        raw[:, :8] = table[pick]
    key = raw[:, 0].to(torch.int64)
    for b in range(1, 8):
        key = (key << 8) | raw[:, b].to(torch.int64)
    return key.cpu().numpy().view(np.uint64), raw[:, 8:].contiguous().cpu().numpy()


def make_pool(traffic: dict, config: dict, seed: int, device, items: int | None = None) -> list:
    """``traffic["pool"]`` job inputs of ``items`` (default: the config's
    ``items_per_job``) each: key arrays, or ``(keys, payload)`` pairs for
    ``terasort``."""
    import torch

    n = int(items or config["items_per_job"])
    pool = []
    for i in range(int(traffic["pool"])):
        gen = torch.Generator(device=device)
        gen.manual_seed(input_seed(seed, i))
        if traffic["distribution"] == "terasort":
            pool.append(_records(traffic, config, n, device, gen))
        else:
            dtype = np.dtype(config["key_dtype"])
            pool.append(_keys(traffic, n, dtype, device, gen).cpu().numpy())
    return pool
