"""The one traffic generator: it reads a traffic file's parameters and makes
a run's requests from the run's seed.

Sizes come from a pool drawn once from the file's own ``pool_seed``, so every
run seed serves the same set of sentence lengths; the run seed decides their
order, the phoneme ids and the speakers. That keeps the work a run does the
same from seed to seed while the inputs differ.
"""

import numpy as np


def rng_for(seed, stream):
    """A numpy Generator for one use (``stream``, a small int) of a run
    seed, which may be any whole number (negative ones are taken mod
    2**64)."""
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed) % 2 ** 64, stream]))


def draw_lengths(spec, n, rng):
    """``n`` lengths from ``spec``: {"dist": "lognormal", "median", "sigma",
    "min", "max"}, rounded to whole numbers and clipped to [min, max]."""
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    x = rng.lognormal(np.log(spec["median"]), spec["sigma"], n)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def length_pool(traffic):
    """The traffic's fixed pool of phoneme counts."""
    rng = np.random.default_rng(traffic["pool_seed"])
    return draw_lengths(traffic["phonemes"], traffic["pool"], rng)


def _orders(traffic, seed, stream):
    """The pool's lengths in the order of one run: a new permutation of the
    pool for each pass."""
    pool = length_pool(traffic)
    rng = rng_for(seed, stream)
    while True:
        yield pool[rng.permutation(len(pool))]


def batch_maxima(traffic, seed, n_batches):
    """The longest sentence of each of the first ``n_batches`` batches that
    ``bulk_batches`` yields for ``seed`` (its default streams)."""
    B, out = traffic["batch"], []
    for lens in _orders(traffic, seed, 1):
        out += [int(lens[i:i + B].max())
                for i in range(0, len(lens) - B + 1, B)]
        if len(out) >= n_batches:
            return out[:n_batches]


def bulk_batches(traffic, seed, n_symbols, n_speakers, streams=(1, 2),
                 longest=None):
    """Endless closed-loop batches of ``traffic["batch"]`` sentences in
    arrival order (no sorting by length): each pass over the pool takes a
    new permutation. Yields dicts with ``phonemes`` (B, max length) int64,
    zero-padded; ``src_lens`` (B,); ``speakers`` (B,). ``streams``: the
    seed's streams for the order and the content. ``longest``: a list of
    lengths; the k-th batch is cut to its k-th entry (each sentence at most
    that long, its first exactly), and the generator ends with the list.
    """
    B = traffic["batch"]
    content_rng = rng_for(seed, streams[1])
    k = 0
    for lens in _orders(traffic, seed, streams[0]):
        for i in range(0, len(lens) - B + 1, B):
            src = lens[i:i + B]
            if longest is not None:
                if k == len(longest):
                    return
                src = np.minimum(src, longest[k])
                src[0] = longest[k]
                k += 1
            ph = content_rng.integers(1, n_symbols, (B, int(src.max())))
            ph[np.arange(ph.shape[1])[None] >= src[:, None]] = 0
            yield {"phonemes": ph, "src_lens": src.astype(np.int32),
                   "speakers": content_rng.integers(0, n_speakers, B)}

