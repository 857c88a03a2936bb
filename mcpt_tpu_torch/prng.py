"""`jax.random`'s default generator in PyTorch, bit for bit.

JAX's default PRNG is threefry2x32 with `jax_threefry_partitionable` on
(the default from JAX 0.5): a pure counter-based function of the key and of
the flat index of each element. This module reproduces `key`, `split`,
`fold_in` and `uniform` (float32) of `jax/_src/prng.py` (`threefry_seed`,
`_threefry2x32_lowering`, `iota_2x32_shape`, `_threefry_split_foldlike`,
`threefry_fold_in`, `_threefry_random_bits_partitionable`) and
`jax/_src/random.py::_uniform`, so the wavefront path draws the very uniforms
the JAX package draws at every use site.

A key is an int64 tensor of shape (2,) holding the two uint32 words of
`jax.random.key_data(key)`; `split` returns (n, 2). Keys live on the
caller's device; no global generator is involved. uint32 arithmetic is done
in int64 tensors masked to 32 bits, or in Python ints (`host_fold_in`,
`host_split`: the wavefront render derives its per-chunk and per-sample
keys on the host, a few hundred integer ops that would each be a device
launch). `bits_at` and `uniform_at` draw single elements by their flat
index, as the wavefront kernels do.
"""

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 hash of counter words (x0, x1) under key words
    (k0, k1): 20 rounds with a key injection after every four. Every
    argument is an int64 tensor of uint32 values (the keys may be
    0-dimensional) or a Python int; returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def key(seed: int, device=None):
    """`jax.random.key(seed)`'s words: the seed's high and low 32 bits."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _M32, seed & _M32], dtype=torch.int64, device=device)


def _iota(shape, device):
    """The low word of `iota_2x32_shape(shape)` (the high word is 0 below
    2^32 elements): each element's row-major flat index."""
    n = 1
    for s in shape:
        n *= int(s)
    if n >= 1 << 32:
        raise ValueError(f"{n} elements: the high counter word would be nonzero")
    return torch.arange(n, dtype=torch.int64, device=device).reshape(tuple(shape))


def split(k, n: int = 2):
    """`jax.random.split(k, n)`: an (n, 2) stack of keys."""
    lo = _iota((n,), k.device)
    b0, b1 = threefry2x32(k[0], k[1], torch.zeros_like(lo), lo)
    return torch.stack([b0, b1], dim=-1)


def fold_in(k, data: int):
    """`jax.random.fold_in(k, data)`: the hash of the counter
    (0, data mod 2^32)."""
    x1 = torch.tensor([int(data) & _M32], dtype=torch.int64, device=k.device)
    b0, b1 = threefry2x32(k[0], k[1], torch.zeros_like(x1), x1)
    return torch.cat([b0, b1])


def host_fold_in(words, data: int):
    """`fold_in` of a key given as its two words (Python ints), computed on
    the host: `threefry2x32` takes ints as it takes tensors."""
    return threefry2x32(int(words[0]), int(words[1]), 0, int(data) & _M32)


def host_split(words, n: int = 2):
    """`split(k, n)` of a key given as its two words, on the host: n pairs."""
    return [threefry2x32(int(words[0]), int(words[1]), 0, i) for i in range(n)]


def random_bits(k, shape):
    """32 random bits per element, as int64 in [0, 2^32)."""
    lo = _iota(shape, k.device)
    b0, b1 = threefry2x32(k[0], k[1], torch.zeros_like(lo), lo)
    return b0 ^ b1


def bits_at(k, idx):
    """The bits of the elements at flat indices `idx` (int64, any shape,
    each below 2^32) of any `random_bits(k, shape)`: the hash of the
    counter (0, idx), so a draw needs only its own index."""
    b0, b1 = threefry2x32(k[0], k[1], torch.zeros_like(idx), idx)
    return b0 ^ b1


def uniform_at(k, idx):
    """The elements at flat indices `idx` of `uniform(k, shape)` (float32,
    [0, 1)), bit for bit: what the wavefront kernels draw per lane."""
    bits = (bits_at(k, idx) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def uniform(k, shape, minval: float = 0.0, maxval: float = 1.0):
    """`jax.random.uniform(k, shape, jnp.float32, minval, maxval)`: the top
    23 bits as the mantissa of a float in [1, 2), minus 1, scaled."""
    bits = (random_bits(k, shape) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=k.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=k.device)
    return torch.maximum(lo, f * (hi - lo) + lo)
