"""float32 rounding of the JAX package's compiled CPU code, for CPU renders.

The port's CPU path (the scan wavefront and the camera stage) reproduces the
JAX package's CPU renders draw for draw, so the golden images gate it. XLA's
CPU backend rounds differently from a plain operation-by-operation float32
evaluation in three ways, which the helpers here reproduce on CPU float32
tensors (on other devices they are the plain operations):

  * ``fma``: a product that feeds a sum is contracted into one fused
    multiply-add (LLVM's rule: in ``a*b + c`` and ``a*b - c`` the left
    product fuses, in ``c + a*b`` the right one). The product is exact in
    float64, so one float64 add and one rounding to float32 give the fused
    result.
  * ``rsqrt``: ``1 / sqrt(x)`` is rewritten to ``rsqrt(x)``, computed as the
    x86 ``rsqrtps`` estimate refined by two Newton steps,
    ``y <- fma(-0.5 * y, fma(x * y, y, -1), y)``. The estimate depends only
    on the exponent's parity and the top 10 mantissa bits; ``_RSQRT_EST``
    holds its 2048 values (12 significant bits each, exponent 126), as
    tabulated from the instruction on an Intel Xeon.
  * ``sqrt``, ``sin``, ``cos``, ``acos`` of PyTorch's vectorised CPU kernels
    differ from XLA's; they are evaluated in float64 and rounded once (the
    IEEE result for ``sqrt``).

float64 (``--dtype float64``, CPU only), as read from XLA's optimised LLVM IR
for jitted float64 code and from its results:

  * ``fma``: XLA contracts float64 products into sums by the same rule.
    PyTorch has no fused multiply-add, so the helper computes its value
    exactly from error-free transforms (Dekker's product, Knuth's sum) and
    carries the plain expression's gradient.
  * ``rsqrt``: XLA also rewrites float64 ``1 / sqrt(x)``, from the AVX-512
    ``vrsqrt14pd`` estimate with the same two Newton steps. That estimate
    is not tabulated here, so float64 takes the plain ``1 / sqrt(x)``:
    the two differ in the last bit on about 3 in 10 inputs.
  * ``sqrt`` is the IEEE result in XLA as in PyTorch. ``sin`` and ``cos``
    in XLA equal numpy's (glibc's) and PyTorch's differ in the last bit
    on about 1 in 500 inputs; ``acos`` differs from both in the last bit
    on about 1 in 8. No float64 evaluation rounds better, so these are the
    plain PyTorch operations.

So a float64 render follows the JAX package's to within a few units in the
last place of each value (the tests hold it to 1e-12), not bit for bit.
"""

from __future__ import annotations

import torch

_RSQRT_EST = (
    "ffeffaff6ff2feefeafe6fe2fdefdafd6fd2fcefcbfc7fc3fbffbbfb7fb3faffabfa7fa4fa0f9cf98f94f90f8cf89f85"
    "f81f7df79f76f72f6ef6af66f63f5ff5bf57f54f50f4cf48f45f41f3df39f36f32f2ef2bf27f23f20f1cf18f15f11f0d"
    "f0af06f02effefbef7ef4ef0eedee9ee5ee2edeedbed7ed3ed0eccec9ec5ec2ebeebaeb7eb3eb0eacea9ea5ea2e9ee9b"
    "e97e94e90e8de89e86e82e7fe7be78e75e71e6ee6ae67e63e60e5de59e56e52e4fe4ce48e45e41e3ee3be37e34e31e2d"
    "e2ae26e23e20e1ce19e16e12e0fe0ce09e05e02dffdfbdf8df5df1deedebde8de4de1ddeddbdd7dd4dd1dcedcadc7dc4"
    "dc1dbedbadb7db4db1daedaada7da4da1d9ed9bd97d94d91d8ed8bd88d84d81d7ed7bd78d75d72d6fd6bd68d65d62d5f"
    "d5cd59d56d53d50d4dd49d46d43d40d3dd3ad37d34d31d2ed2bd28d25d22d1fd1cd19d16d13d10d0dd0ad07d04d01cfe"
    "cfbcf8cf5cf2cefcecce9ce6ce3ce0cddcdbcd8cd5cd2ccfccccc9cc6cc3cc0cbdcbacb8cb5cb2cafcacca9ca6ca3ca1"
    "c9ec9bc98c95c92c8fc8dc8ac87c84c81c7ec7cc79c76c73c70c6ec6bc68c65c62c60c5dc5ac57c54c52c4fc4cc49c47"
    "c44c41c3ec3cc39c36c33c31c2ec2bc28c26c23c20c1ec1bc18c15c13c10c0dc0bc08c05c03c00bfdbfbbf8bf5bf3bf0"
    "bedbebbe8be5be3be0bddbdbbd8bd5bd3bd0bcebcbbc8bc6bc3bc0bbebbbbb9bb6bb3bb1baebacba9ba7ba4ba1b9fb9c"
    "b9ab97b95b92b8fb8db8ab88b85b83b80b7eb7bb79b76b73b71b6eb6cb69b67b64b62b5fb5db5ab58b55b53b50b4eb4b"
    "b49b46b44b41b3fb3db3ab38b35b33b30b2eb2bb29b26b24b22b1fb1db1ab18b15b13b11b0eb0cb09b07b05b02b00afd"
    "afbaf9af6af4af1aefaedaeaae8ae5ae3ae1adeadcadaad7ad5ad3ad0aceacbac9ac7ac4ac2ac0abdabbab9ab6ab4ab2"
    "aafaadaabaa8aa6aa4aa2a9fa9da9ba98a96a94a91a8fa8da8ba88a86a84a82a7fa7da7ba78a76a74a72a6fa6da6ba69"
    "a66a64a62a60a5da5ba59a57a55a52a50a4ea4ca49a47a45a43a41a3ea3ca3aa38a36a33a31a2fa2da2ba28a26a24a22"
    "a20a1da1ba19a17a15a13a10a0ea0ca0aa08a06a04a019ff9fd9fb9f99f79f59f29f09ee9ec9ea9e89e69e49e19df9dd"
    "9db9d99d79d59d39d19ce9cc9ca9c89c69c49c29c09be9bc9ba9b79b59b39b19af9ad9ab9a99a79a59a39a199f99d99b"
    "99999799499299098e98c98a98898698498298097e97c97a97897697497297096e96c96a96896696496296095e95c95a"
    "95895695495295094e94c94a94894694494294093e93c93a93893793593393192f92d92b92992792592392191f91d91b"
    "91991791691491291090e90c90a9089069049029008ff8fd8fb8f98f78f58f38f18ef8ed8ec8ea8e88e68e48e28e08de"
    "8dc8db8d98d78d58d38d18cf8ce8cc8ca8c88c68c48c28c18bf8bd8bb8b98b78b58b48b28b08ae8ac8aa8a98a78a58a3"
    "8a189f89e89c89a89889689589389188f88d88c88a88888688488388187f87d87b87a87887687487287186f86d86b86a"
    "86886686486286185f85d85b85a85885685485385184f84d84c84a84884684584384183f83e83c83a838837835833831"
    "83082e82c82b82982782582482282081f81d81b81981881681481381180f80d80c80a8088078058038028007fe7fd7fb"
    "7f97f77f67f47f27f17ef7ed7ec7ea7e87e77e57e37e27e07de7dd7db7d97d87d67d47d37d17d07ce7cc7cb7c97c77c6"
    "7c47c27c17bf7be7bc7ba7b97b77b57b47b27b07af7ad7ac7aa7a87a77a57a47a27a079f79d79b79a798797795793792"
    "79078f78d78b78a78878778578478278077f77d77c77a77877777577477277176f76d76c76a76976776676476276175f"
    "75e75c75b75975875675475375175074e74d74b74a74874774574474274073f73d73c73a73973773673473373173072e"
    "72d72b72a72872772572372272071f71d71c71a71971771671471371171070e70d70b70a7087077057047037017006fe"
    "6fd6fb6fa6f86f76f56f46f26f16ef6ee6ec6eb6e96e86e66e56e46e26e16df6de6dc6db6d96d86d66d56d36d26d16cf"
    "6ce6cc6cb6c96c86c66c56c46c26c16bf6be6bc6bb6ba6b86b76b56b46b26b16b06ae6ad6ab6aa6a86a76a66a46a36a1"
    "69f69c69a69769469168e68c68968668368067e67b67867567367066d66a66766566265f65d65a65765465264f64c64a"
    "64764464163f63c63963763463162f62c62962762462161f61c61961761461260f60c60a6076056025ff5fd5fa5f85f5"
    "5f25f05ed5eb5e85e65e35e05de5db5d95d65d45d15cf5cc5ca5c75c45c25bf5bd5ba5b85b55b35b05ae5ab5a95a75a4"
    "5a259f59d59a59859559359058e58b58958758458257f57d57a57857657357156e56c56a56756556256055e55b559557"
    "55455254f54d54b54854654454153f53d53a53853653353152f52c52a52852552352151e51c51a51851551351150e50c"
    "50a5085055035014ff4fc4fa4f84f64f34f14ef4ed4ea4e84e64e44e14df4dd4db4d94d64d44d24d04ce4cb4c94c74c5"
    "4c34c04be4bc4ba4b84b64b34b14af4ad4ab4a94a64a44a24a049e49c49a49749549349148f48d48b489486484482480"
    "47e47c47a47847647447146f46d46b46946746546346145f45d45b45945745545245044e44c44a44844644444244043e"
    "43c43a43843643443243042e42c42a42842642442242041e41c41a41841641441241040e40c40a4084064044024003fe"
    "3fd3fb3f93f73f53f33f13ef3ed3eb3e93e73e53e33e13e03de3dc3da3d83d63d43d23d03ce3cc3cb3c93c73c53c33c1"
    "3bf3bd3bc3ba3b83b63b43b23b03ae3ad3ab3a93a73a53a33a13a039e39c39a39839639539339138f38d38b38a388386"
    "38438238137f37d37b37937837637437237036f36d36b36936736636436236035e35d35b35935735635435235034f34d"
    "34b34934834634434234133f33d33b33a33833633433333132f32e32c32a32832732532332232031e31c31b319317316"
    "31431231130f30d30b30a3083063053033013002fe2fc2fb2f92f72f62f42f22f12ef2ed2ec2ea2e82e72e52e32e22e0"
    "2df2dd2db2da2d82d62d52d32d12d02ce2cd2cb2c92c82c62c52c32c12c02be2bc2bb2b92b82b62b42b32b12b02ae2ac"
    "2ab2a92a82a62a52a32a12a029e29d29b29a29829629529329229028f28d28b28a28828728528428228127f27e27c27a"
    "27927727627427327127026e26d26b26a26826726526326226025f25d25c25a25925725625425325125024e24d24b24a"
    "24824724524424224123f23e23d23b23a23823723523423223122f22e22c22b22922822622522422222121f21e21c21b"
    "21921821621521421221120f20e20c20b20a2082072052042022012001fe1fd1fb1fa1f81f71f61f41f31f11f01ef1ed"
    "1ec1ea1e91e81e61e51e31e21e11df1de1dc1db1da1d81d71d51d41d31d11d01cf1cd1cc1ca1c91c81c61c51c41c21c1"
    "1bf1be1bd1bb1ba1b91b71b61b51b31b21b01af1ae1ac1ab1aa1a81a71a61a41a31a21a019f19e19c19b19a198197196"
    "19419319219018f18e18c18b18a18818718618518318218117f17e17d17b17a17917717617517417217117016e16d16c"
    "16b16916816716516416316216015f15e15c15b15a15915715615515315215115014e14d14c14b149148147146144143"
    "14214113f13e13d13c13a13913813713513413313213012f12e12d12b12a12912812612512412312212011f11e11d11b"
    "11a11911811711511411311211010f10e10d10c10a1091081071061041031021011000fe0fd0fc0fb0fa0f80f70f60f5"
    "0f40f20f10f00ef0ee0ed0eb0ea0e90e80e70e50e40e30e20e10e00de0dd0dc0db0da0d90d70d60d50d40d30d20d00cf"
    "0ce0cd0cc0cb0c90c80c70c60c50c40c30c10c00bf0be0bd0bc0bb0b90b80b70b60b50b40b30b10b00af0ae0ad0ac0ab"
    "0a90a80a70a60a50a40a30a20a009f09e09d09c09b09a09909809609509409309209109008f08e08c08b08a089088087"
    "08608508408208108007f07e07d07c07b07a07907807607507407307207107006f06e06d06c06b069068067066065064"
    "06306206106005f05e05d05b05a05905805705605505405305205105004f04e04d04c04a049048047046045044043042"
    "04104003f03e03d03c03b03a03903803703603403303203103002f02e02d02c02b02a029028027026025024023022021"
    "02001f01e01d01c01b01a01901801701601501401301201101000f00e00d00c00b00a009008007006005004003002001"
)
_RSQRT_TABLE = None


def cpu32(*xs) -> bool:
    """True when every tensor argument is a float32 CPU tensor."""
    ts = [x for x in xs if isinstance(x, torch.Tensor)]
    return bool(ts) and all(t.device.type == "cpu" and t.dtype == torch.float32 for t in ts)


def via64(fn, x: torch.Tensor) -> torch.Tensor:
    if cpu32(x):
        return fn(x.double()).float()
    return fn(x)


def cpu64(*xs) -> bool:
    """True when every tensor argument is a float64 CPU tensor."""
    ts = [x for x in xs if isinstance(x, torch.Tensor)]
    return bool(ts) and all(t.device.type == "cpu" and t.dtype == torch.float64 for t in ts)


_SPLIT64 = 134217729.0  # 2^27 + 1: Dekker's split of a float64


def _fma64(a, b, c):
    """a * b + c rounded once, for float64 CPU tensors: the exact product
    a*b = p + e (Dekker), p + c = s + t (Knuth), then s + (t + e); the
    gradient is the plain expression's."""
    plain = a * b + c
    with torch.no_grad():
        a_, b_, c_ = (x.detach() if isinstance(x, torch.Tensor) else x for x in (a, b, c))
        p = a_ * b_
        ca = _SPLIT64 * a_
        ah = ca - (ca - a_)
        al = a_ - ah
        cb = _SPLIT64 * b_
        bh = cb - (cb - b_)
        bl = b_ - bh
        e = (((ah * bh - p) + ah * bl) + al * bh) + al * bl
        s = p + c_
        v = s - p
        t = (p - (s - v)) + (c_ - v)
        r = s + (t + e)
        # overflow or a non-finite input: the plain value
        r = torch.where(torch.isfinite(r), r, plain.detach())
    if plain.requires_grad:
        return r + (plain - plain.detach())
    return r


def fma(a, b, c):
    """a * b + c, rounded once on the CPU. A Python number operand is a
    constant of the tensors' dtype, as in XLA."""
    if cpu32(a, b, c):
        d = lambda x: x.double() if isinstance(x, torch.Tensor) else \
            float(torch.tensor(x, dtype=torch.float32))
        return (d(a) * d(b) + d(c)).float()
    if cpu64(a, b, c):
        return _fma64(a, b, c)
    return a * b + c


def _table() -> torch.Tensor:
    global _RSQRT_TABLE
    if _RSQRT_TABLE is None:
        s = "".join(_RSQRT_EST)
        mant = torch.tensor([int(s[i:i + 3], 16) for i in range(0, len(s), 3)],
                            dtype=torch.int32)
        _RSQRT_TABLE = ((mant << 11) | (126 << 23)).view(torch.float32)
    return _RSQRT_TABLE


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(x) with XLA's CPU rounding (on the CPU)."""
    if not cpu32(x):
        return 1.0 / torch.sqrt(x)
    # the estimate is a table constant: its bits carry no gradient
    bits = x.detach().view(torch.int32).to(torch.int64)
    e = ((bits >> 23) & 0xFF) - 127
    m = (bits >> 13) & 0x3FF
    p = e & 1
    y = torch.ldexp(_table()[p * 1024 + m], -((e - p) // 2)).to(torch.float32)
    for _ in range(2):
        y = fma(y * -0.5, fma(x * y, y, -1.0), y)
    normal = (x > 0) & torch.isfinite(x) & (x >= torch.finfo(torch.float32).tiny)
    return torch.where(normal, y, (1.0 / torch.sqrt(x.double())).float())
