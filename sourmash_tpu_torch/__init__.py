"""sourmash_tpu_torch: the PyTorch + CUDA port of `sourmash_tpu`.

FracMinHash sketching and gather with API and output parity to sourmash
(https://github.com/sourmash-bio/sourmash). The sketch and gather hot paths
run hand-written CUDA kernels (`csrc/`) on an NVIDIA Hopper card; the host
layer holds sketches as sorted numpy uint64 arrays, as `sourmash_tpu` does.

The port imports neither jax nor `sourmash_tpu`. Entry points run on CUDA
unless the caller asks for the CPU (`device=` on library calls,
SOURMASH_TORCH_DEVICE for the CLI); see `ops/__init__.py`.
"""

VERSION = "0.1.0"
__version__ = VERSION

from .minhash import (  # noqa: E402
    MinHash,
    FrozenMinHash,
    hash_murmur,
    get_minhash_default_seed,
    get_minhash_max_hash,
    minhash_from_arrays,
)
from .signature import (  # noqa: E402
    SourmashSignature,
    FrozenSourmashSignature,
    load_signatures_from_json,
    load_one_signature_from_json,
    save_signatures_to_json,
    signature_from_arrays,
)

__all__ = [
    "MinHash",
    "FrozenMinHash",
    "SourmashSignature",
    "FrozenSourmashSignature",
    "load_signatures_from_json",
    "load_one_signature_from_json",
    "save_signatures_to_json",
    "hash_murmur",
    "get_minhash_default_seed",
    "get_minhash_max_hash",
    "minhash_from_arrays",
    "signature_from_arrays",
]
