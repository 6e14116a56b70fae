"""Knapsack inputs shared by the CPU tests (the plain twin against the JAX
package) and the card tests (the kernel against the twin): shot rows as
``keyshot_summ`` hands them over (values int(1000 x mean score), weights
the shots' frame counts, capacity 15 % of the frames, padding slots of
value 0 and weight 0), at the shapes the benchmark's cells solve, past
the kernel's shared memory, and the edge cases.  Imports neither JAX nor
edsnet_tpu."""
import numpy as np
import torch

SHOT_FRAMES = (45, 150)        # 1.5-5 s shots, as the benchmark's traffic


def max_capacity(frame_bucket):
    """``keyshot_summ``'s DP width at a frame bucket."""
    return int(frame_bucket * 0.15) + 1


def shots(seed, frames, n, bucket):
    """(values [B, n], weights [B, n], capacity [B], max_capacity) for
    videos of ``frames`` frames cut into 1.5-5 s shots, padded to ``n``
    slots, at the DP width of a ``bucket``-frame bucket."""
    rng = np.random.RandomState(seed)
    b = len(frames)
    values = np.zeros((b, n), np.int64)
    weights = np.zeros((b, n), np.int64)
    for i, total in enumerate(frames):
        cuts = [0]
        while cuts[-1] < total:
            cuts.append(min(total, cuts[-1] + rng.randint(*SHOT_FRAMES)))
        lengths = np.diff(cuts)
        assert len(lengths) <= n, (len(lengths), n)
        weights[i, :len(lengths)] = lengths
        values[i, :len(lengths)] = rng.randint(0, 1000, len(lengths))
    capacity = (np.asarray(frames) * 0.15).astype(np.int64)
    return (torch.from_numpy(values), torch.from_numpy(weights),
            torch.from_numpy(capacity), max_capacity(bucket))


def drawn(seed, b, n, cap_max, v_max, w_max, capacity=None):
    """Random rows: values in [0, v_max), weights in [0, w_max), capacities
    in [0, cap_max] (or the given ones)."""
    rng = np.random.RandomState(seed)
    values = rng.randint(0, v_max, (b, n))
    weights = rng.randint(0, w_max, (b, n))
    if capacity is None:
        capacity = rng.randint(0, cap_max + 1, b)
    return (torch.from_numpy(values), torch.from_numpy(weights),
            torch.tensor(capacity, dtype=torch.int64).reshape(b), cap_max)


def edited(case, edit):
    """``case`` with ``edit(values, weights, capacity, max_capacity)``
    applied in place to its numpy arrays."""
    values, weights, capacity, cap_max = case
    arrays = [t.numpy().copy() for t in (values, weights, capacity)]
    edit(*arrays, cap_max)
    return (*(torch.from_numpy(a) for a in arrays), cap_max)


def _padding(values, weights, capacity, cap_max):
    values[:, 10:] = 0
    weights[:, 10:] = 0


def _zero_weight(values, weights, capacity, cap_max):
    weights[:, ::3] = 0                 # free items, most of value > 0


def _overweight(values, weights, capacity, cap_max):
    weights[:, 1::4] = capacity[:, None] + 1 + np.arange(
        weights[:, 1::4].shape[1])
    weights[:, 2::4] = cap_max + 50     # past the DP width too


# name -> (values, weights, capacity, max_capacity): the cells' shapes, a
# row whose take bits overflow shared memory (the global-bits path) and
# one whose DP vector does too, then the edge cases
CASES = {
    # eval-summe: frame buckets 4096 / 8192 / 12288, shots padded to 16
    "eval-615-n16": lambda: shots(0, [1300], 16, 4096),
    "eval-615-n32": lambda: shots(16, [1800], 32, 4096),
    "eval-1229-n80-b4": lambda: shots(1, [7200, 6500, 4500, 4100], 80,
                                      8192),
    "eval-1844-n128": lambda: shots(2, [11700], 128, 12288),
    "eval-1844-n128-b2": lambda: shots(3, [11700, 8300], 128, 12288),
    # train-tvsum's largest: 1200 positions, a 20480-frame bucket
    "train-3073-n192": lambda: shots(4, [18000], 192, 20480),
    # a 30 min video: ~554 shots, take bits of ~620 KB
    "global-bits-8602-n576": lambda: shots(5, [54000], 576, 57344),
    # a DP vector of 30001 ints a buffer, past shared memory itself
    "global-dp-30000-n24": lambda: drawn(6, 2, 24, 30000, 1000, 3000,
                                         [29990, 17000]),
    "ties-b16": lambda: drawn(7, 16, 12, 60, 5, 25),
    "ties-wide-b8": lambda: drawn(8, 8, 77, 615, 3, 60),
    "padding-b4": lambda: edited(drawn(9, 4, 32, 200, 50, 40), _padding),
    "zero-weight-b4": lambda: edited(drawn(10, 4, 24, 100, 20, 30),
                                     _zero_weight),
    "overweight-b4": lambda: edited(drawn(11, 4, 24, 100, 20, 30),
                                    _overweight),
    "capacity-0-b3": lambda: drawn(12, 3, 16, 40, 9, 6, [0, 0, 0]),
    "capacity-max-b2": lambda: drawn(13, 2, 40, 300, 100, 40, [300, 300]),
    "mixed-b8": lambda: drawn(14, 8, 48, 500, 200, 60,
                              [0, 1, 37, 250, 499, 500, 500, 3]),
    "single-item-b2": lambda: drawn(15, 2, 1, 20, 30, 25, [20, 7]),
}
