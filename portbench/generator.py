"""The one traffic generator: reads a mix's data file and a configuration's
input streams and key population, and makes a seeded pool of batches.

A mix (``portbench/traffic/<name>.json``) gives ``batch`` (rows a send),
``pool_batches`` (batches made at set-up for each stream, then cycled) and,
under ``streams``, each input stream it feeds with a distribution for each
column of that stream's schema in the configuration's ``inputs``:

- ``keys_uniform``: key ids uniform over ``keys.count``; a string column
  sends ``keys.prefix + str(id)``;
- ``keys_zipf`` with ``exponent``: key ids drawn with probability
  proportional to ``rank ** -exponent``, ranks given to ids in a seeded
  order;
- ``uniform`` with ``low``, ``high``: floats in ``[low, high)``;
- ``uniform_int`` with ``low``, ``high``: integers in ``[low, high)``.

Send ``g`` goes to the mix's streams in turn, in the order listed, and
carries the timestamps ``g * batch ... (g + 1) * batch - 1``; a stream's
``k``-th send is its pool batch ``k % pool_batches``. The same seed gives
the same pool; every seed gives the same sizes. Sampling happens here, at
set-up, and never on the timed loop's thread.
"""

from __future__ import annotations

import numpy as np

DTYPES = {"int": np.int32, "long": np.int64,
          "float": np.float32, "double": np.float64, "bool": np.bool_}


def seed_sequence(seed: int, *salt: int) -> np.random.SeedSequence:
    """Any whole number (negative and above 64 bits included) as entropy."""
    return np.random.SeedSequence([int(seed) % (1 << 64), *salt])


class Traffic:
    def __init__(self, config: dict, mix: dict, seed: int):
        self.batch = int(mix["batch"])
        self.pool_batches = int(mix["pool_batches"])
        self.streams = list(mix["streams"])
        missing = [s for s in self.streams if s not in config["inputs"]]
        if missing:
            raise ValueError(f"the mix feeds streams the configuration lacks: {missing}")
        keys = config["keys"]
        self.n_keys = int(keys["count"])
        self.strings = np.array([f"{keys.get('prefix', '')}{i}"
                                 for i in range(self.n_keys)], dtype=object)
        rng = np.random.default_rng(seed_sequence(seed))
        n = self.batch * self.pool_batches
        self.pool = {}          # stream -> column -> [pool_batches, batch]
        self._sent = {}         # the same, string columns as strings
        for s in self.streams:
            schema, dists = config["inputs"][s], mix["streams"][s]
            self.pool[s] = {col: _draw(rng, dists[col], kind, n, self.n_keys)
                            .reshape(self.pool_batches, self.batch)
                            for col, kind in schema.items()}
            self._sent[s] = {c: (self.strings[v] if schema[c] == "string" else v)
                             for c, v in self.pool[s].items()}

    def stream(self, g: int) -> str:
        """The input stream send ``g`` goes to."""
        return self.streams[g % len(self.streams)]

    def _slot(self, g: int) -> int:
        return (g // len(self.streams)) % self.pool_batches

    def columns(self, g: int) -> dict:
        """Send ``g``'s columns as the program receives them."""
        p = self._slot(g)
        return {c: v[p] for c, v in self._sent[self.stream(g)].items()}

    def timestamps(self, g: int) -> np.ndarray:
        return np.arange(g * self.batch, (g + 1) * self.batch, dtype=np.int64)

    def raw(self, g: int) -> dict:
        """Send ``g``'s columns as the benchmark made them: string columns
        as key ids (the reference's input, the same data the program gets)."""
        p = self._slot(g)
        return {c: v[p] for c, v in self.pool[self.stream(g)].items()}

    def raw_range(self, lo: int, hi: int, stream: str = None) -> dict:
        """The sends ``lo .. hi - 1`` to ``stream`` (by default the stream of
        send ``hi - 1``) concatenated, as ``raw``."""
        stream = stream or self.stream(hi - 1)
        sends = [g for g in range(lo, hi) if self.stream(g) == stream]
        return {c: np.concatenate([self.raw(g)[c] for g in sends])
                for c in self.pool[stream]}


def _draw(rng, spec: dict, kind: str, n: int, n_keys: int) -> np.ndarray:
    dist = spec["dist"]
    if dist == "keys_uniform":
        return rng.integers(0, n_keys, n, dtype=np.int64)
    if dist == "keys_zipf":
        w = np.arange(1, n_keys + 1, dtype=np.float64) ** -float(spec["exponent"])
        ids = rng.permutation(n_keys)
        return ids[rng.choice(n_keys, size=n, p=w / w.sum())].astype(np.int64)
    dtype = DTYPES[kind]
    if dist == "uniform":
        lo, hi = float(spec["low"]), float(spec["high"])
        return (lo + rng.random(n) * (hi - lo)).astype(dtype)
    if dist == "uniform_int":
        return rng.integers(int(spec["low"]), int(spec["high"]), n).astype(dtype)
    raise ValueError(f"unknown distribution {dist!r}")
