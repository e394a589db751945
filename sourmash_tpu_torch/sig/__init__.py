"""'sourmash signature' subcommand implementations (the port's copy of
`sourmash_tpu/sig/`).

The subcommand functions are importable at package level
(`sourmash.sig.cat(args)` etc.), matching the reference's
`src/sourmash/sig/__main__.py` re-export surface.
"""

from .__main__ import (  # noqa: F401
    cat,
    split,
    describe,
    manifest,
    overlap,
    merge,
    intersect,
    inflate,
    subtract,
    rename,
    extract,
    filter,
    flatten,
    downsample,
    ingest,
    export,
    kmers,
    fileinfo,
    check,
    collect,
    grep,
)
