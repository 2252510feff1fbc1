"""K9's sort and session passes (csrc/dwin_step.cu): the CPU model of the
radix sort, the wavelet matrix and the keyed runs against the twin and
the JAX package.

- ``dwin_pass_model`` (4-entry blocks, so the radix and wavelet passes
  span many blocks) == ``dwin_step_plain`` == the JAX ``build_dwin_step``,
  bit for bit (the model on the rows up to the count, the tail and every
  carry leaf; the twin and JAX on the whole buffer), over chained steps
  that ``tests/test_torch_dwin.py`` never makes: NaN, ±0.0 and ±inf float
  sort keys at key 0 and at a later key, ascending and descending, with
  one key and with several; n = 1 and n beyond the pool; all-equal keys;
  LONG (hi, lo) keys at the int32 extremes; sessions with one key, with
  every key distinct, and keyless.
- The prefix rule: on random feeds with NaN keys, the entries before x in
  the stable order-key sort (or before the run sharing x's keys up to
  its first NaN) are exactly the twin's lex-predecessors of x; the
  model's radix sort is that stable sort.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siddhi_tpu.ops import dwin as J
from siddhi_tpu_torch.ops import dwin as D

#: name: (DwinSpec fields, feed)
SPECS = {
    "sort_nan_key0_asc": (("sort", 8, 1, 1, 0, 3, ((0, 0, True),)), "nan"),
    "sort_nan_key0_desc": (("sort", 8, 1, 1, 0, 3, ((0, 0, False),)),
                           "nan"),
    "sort_nan_later_key": (("sort", 8, 2, 1, 0, 3,
                            ((1, 0, True), (0, 1, False))), "nan"),
    "sort_nan_three_keys": (("sort", 8, 3, 1, 0, 4,
                             ((0, 0, False), (0, 1, True), (0, 2, False))),
                            "nan"),
    "sort_n1": (("sort", 8, 1, 1, 0, 1, ((0, 0, True),)), "nan"),
    "sort_n_beyond_pool": (("sort", 8, 1, 1, 0, 40, ((0, 0, True),)),
                           "nan"),
    "sort_all_equal": (("sort", 8, 1, 2, 0, 3,
                        ((0, 0, True), (1, 1, False))), "equal"),
    "sort_long_hi_lo": (("sort", 8, 1, 2, 0, 3,
                         ((1, 0, False), (1, 1, False))), "long"),
    "session_one_key": (("session", 8, 1, 2, 300, 0, (), 1), "one_key"),
    "session_distinct": (("session", 8, 1, 2, 300, 0, (), 1), "distinct"),
    "session_keyless": (("session", 8, 1, 1, 300, 0, (), 0), "keyless"),
}

SPECIAL = np.asarray([np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 1.0,
                      -1.0], np.float32)
I32 = np.iinfo(np.int32)


def _steps(spec, feed, seed, n_steps=8, sizes=(1, 4, 11)):
    """Chained step inputs (numpy), as tests/test_torch_dwin.py's
    generator but for the feeds named above."""
    rng = np.random.default_rng(seed)
    F, I = max(spec.n_f, 1), max(spec.n_i, 1)
    t0, code = 1000, 0
    out = []
    for _ in range(n_steps):
        T = int(rng.choice(sizes))
        ev_f = rng.integers(0, 3, (1, T, F)).astype(np.float32)
        if feed == "nan":
            m = rng.random((1, T, F)) < 0.5
            ev_f[m] = rng.choice(SPECIAL, int(m.sum()))
        if feed == "equal":
            ev_f[:] = -0.0 if rng.random() < 0.5 else 0.0
        ev_i = rng.integers(-2, 3, (1, T, I)).astype(np.int32)
        if feed == "equal":
            ev_i[:] = 5
        if feed == "long":
            ext = np.asarray([I32.min, I32.min + 1, -1, 0, 1, I32.max - 1,
                              I32.max], np.int32)
            ev_i[0, :, 0] = rng.choice(ext[2:5], T)
            ev_i[0, :, 1] = rng.choice(ext, T)
        if feed == "one_key":
            ev_i[0, :, 1] = 7
        if feed == "distinct":
            ev_i[0, :, 1] = code + np.arange(T)
            code += T
        if feed == "keyless":
            ev_i[:] = 0
        ts = t0 + np.cumsum(rng.integers(0, 40, T))
        valid = np.ones((1, T), bool)
        if rng.random() < 0.15:
            valid[:] = False
        t0 = int(ts.max()) + 1
        now = np.asarray([t0 + int(rng.integers(-50, 500))], np.int32)
        directive = np.zeros((1, T), np.int32)
        out.append((ev_f, ev_i, ts[None].astype(np.int32), valid, now,
                    directive, 2 * spec.capacity + T))
    return out


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("name", sorted(SPECS))
def test_pass_model_equals_plain_and_jax(name):
    fields, feed = SPECS[name]
    spec_t, spec_j = D.DwinSpec(*fields), J.DwinSpec(*fields)
    step_j = jax.jit(J.build_dwin_step(spec_j), static_argnums=7)
    emitted = 0
    with np.errstate(all="ignore"):
        for seed in (0, 1):
            cj = {k: jnp.asarray(v)
                  for k, v in J.make_dwin_carry(spec_j, 1).items()}
            ct = D.make_dwin_carry(spec_t, 1, "cpu")
            for s, (*inp, cap) in enumerate(_steps(spec_t, feed, seed)):
                npc = {k: v.numpy() for k, v in ct.items()}
                cm, bm = D.dwin_pass_model(spec_t, npc, *inp, cap, block=4)
                cj, bj = step_j(cj, *[jnp.asarray(a) for a in inp], cap)
                ct, bt = D.dwin_step_plain(
                    spec_t, ct, *[torch.from_numpy(a) for a in inp], cap)
                bt = bt.numpy()
                where = (name, seed, s)
                assert np.array_equal(np.asarray(bj), bt), where
                n = min(int(bt[-1, 0]), cap)
                emitted += n
                assert np.array_equal(bm[:n], bt[:n]), where
                assert np.array_equal(bm[cap:], bt[cap:]), where
                for k in ct:
                    assert np.array_equal(_bits(cj[k]),
                                          _bits(ct[k].numpy())), (where, k)
                    assert np.array_equal(_bits(cm[k]),
                                          _bits(ct[k].numpy())), (where, k)
    if name != "sort_n_beyond_pool":
        assert emitted, name


def _twin_less(vals, keys, rank, live):
    """The twin's less[x, y] (y is a lex-predecessor of x), in numpy."""
    M = len(rank)
    less = np.zeros((M, M), bool)
    eq = np.ones((M, M), bool)
    with np.errstate(invalid="ignore"):
        for k, (bank, asc) in enumerate(keys):
            a, b = vals[k][:, None], vals[k][None, :]
            lt = (b < a) if asc else (b > a)
            less |= eq & lt
            eq &= b == a
    less |= eq & (rank[None, :] < rank[:, None])
    return less & live[None, :]


@pytest.mark.parametrize("n_keys", [1, 2, 3])
def test_prefix_rule_gives_the_twin_less(n_keys):
    rng = np.random.default_rng(n_keys)
    for trial in range(40):
        M = int(rng.integers(1, 30))
        keys = [(int(rng.integers(0, 2)), bool(rng.integers(0, 2)))
                for _ in range(n_keys)]
        vals, okeys = [], []
        for bank, asc in keys:
            if bank == 0:
                v = rng.integers(-2, 3, M).astype(np.float32)
                m = rng.random(M) < 0.4
                v[m] = rng.choice(SPECIAL, int(m.sum()))
                bits = v.view(np.int32)
            else:
                v = rng.integers(-2, 3, M).astype(np.int32)
                bits = v
            vals.append(v)
            okeys.append(D.order_keys(bits, bank, asc))
        rank = np.arange(M)
        live = np.ones(M, bool)
        less = _twin_less(vals, keys, rank, live)
        srt = np.lexsort([rank] + okeys[::-1])           # stable by rank
        assert np.array_equal(D.radix_sort_model(okeys, M, 4), srt)
        nan_first = np.full(M, -1)
        for k in reversed(range(n_keys)):
            if keys[k][0] == 0:
                nan_first[np.isnan(vals[k])] = k
        plen = D.sort_prefix_lengths(okeys, nan_first, srt)
        for x in range(M):
            pred = np.zeros(M, bool)
            pred[srt[:plen[x]]] = True
            assert np.array_equal(pred, less[x]), (n_keys, trial, x)


def test_wavelet_kth_is_the_prefix_order_statistic():
    rng = np.random.default_rng(9)
    for L in (1, 2, 7, 33, 100):
        seq = rng.permutation(L)
        nbits = max((L - 1).bit_length(), 1)
        R, Z = D.wavelet_model(seq, nbits, 4)
        for length in range(L + 1):
            srt = np.sort(seq[:length])
            for k in range(length):
                assert D.wavelet_kth(R, Z, nbits, k, length) == srt[k]
