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
    "load_file_as_index",
    "load_file_as_signatures",
    "DEFAULT_LOAD_K",
    "DEFAULT_SEED",
    "MAX_HASH",
    "create_sbt_index",
    "load_sbt_index",
    "search_sbt_index",
]

DEFAULT_LOAD_K = 31


def load_file_as_index(filename, *, yield_all_files=False):
    "Load a filename as a signature collection/index (loader chain)."
    from .save_load import load_file_as_index as _impl

    return _impl(filename, yield_all_files=yield_all_files)


def load_file_as_signatures(
    filename,
    *,
    select_moltype=None,
    ksize=None,
    picklist=None,
    yield_all_files=False,
    progress=None,
    pattern=None,
):
    "Load a filename and return an iterator over signatures."
    from .sourmash_args import load_file_as_signatures as _impl

    return _impl(
        filename,
        select_moltype=select_moltype,
        ksize=ksize,
        picklist=picklist,
        yield_all_files=yield_all_files,
        progress=progress,
        pattern=pattern,
    )


# -- deprecated aliases (reference __init__.py:31-75; remove in 5.0) ------


def load_one_signature(*args, **kwargs):
    "Deprecated: use load_one_signature_from_json / load_file_as_signatures."
    import warnings

    warnings.warn(
        "load_one_signature is deprecated; use load_one_signature_from_json",
        DeprecationWarning,
        stacklevel=2,
    )
    return load_one_signature_from_json(*args, **kwargs)


def load_signatures(*args, **kwargs):
    "Deprecated: use load_signatures_from_json."
    import warnings

    warnings.warn(
        "load_signatures is deprecated; use load_signatures_from_json",
        DeprecationWarning,
        stacklevel=2,
    )
    return load_signatures_from_json(*args, **kwargs)


def save_signatures(*args, **kwargs):
    "Deprecated: use save_signatures_to_json."
    import warnings

    warnings.warn(
        "save_signatures is deprecated; use save_signatures_to_json",
        DeprecationWarning,
        stacklevel=2,
    )
    return save_signatures_to_json(*args, **kwargs)


DEFAULT_SEED = get_minhash_default_seed()
MAX_HASH = get_minhash_max_hash()


def create_sbt_index(*args, **kwargs):
    "Create an empty SBT index (reference __init__.py:143)."
    from .sbtmh import create_sbt_index as _impl

    return _impl(*args, **kwargs)


def load_sbt_index(*args, **kwargs):
    "Deprecated: use load_file_as_index (reference __init__.py:106-118)."
    import warnings

    warnings.warn(
        "load_sbt_index is deprecated; use load_file_as_index",
        DeprecationWarning,
        stacklevel=2,
    )
    from .sbtmh import load_sbt_index as _impl

    return _impl(*args, **kwargs)


def search_sbt_index(*args, **kwargs):
    "Deprecated: use Index.search (reference __init__.py:121-140)."
    import warnings

    warnings.warn(
        "search_sbt_index is deprecated; use index.search(...)",
        DeprecationWarning,
        stacklevel=2,
    )
    from .sbtmh import search_sbt_index as _impl

    return _impl(*args, **kwargs)
