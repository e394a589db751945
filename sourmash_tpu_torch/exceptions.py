"""Exception hierarchy (mirrors reference `src/sourmash/exceptions.py`,
which is generated from Rust error codes in `src/core/src/errors.rs`)."""


class SourmashError(Exception):
    def __init__(self, msg):
        super().__init__(msg)
        self.message = msg


class IndexNotSupported(SourmashError):
    def __init__(self, msg=None):
        super().__init__(
            msg
            or "This index format is not supported in this version of sourmash"
        )


# mismatch errors are ValueErrors at the Python surface (the reference
# maps the corresponding Rust error codes onto ValueError subclasses;
# e.g. tests assert `pytest.raises(ValueError)` on seed mismatches)
class MismatchKSizes(SourmashError, ValueError):
    pass


class MismatchDNAProt(SourmashError, ValueError):
    pass


class MismatchScaled(SourmashError, ValueError):
    pass


class MismatchSeed(SourmashError, ValueError):
    pass


class MismatchSignatureType(SourmashError):
    pass


class NonEmptyMinHash(SourmashError):
    pass


class MismatchNum(SourmashError, ValueError):
    pass


class InvalidDNA(SourmashError):
    pass


class InvalidProt(SourmashError):
    pass


class CannotUpsampleScaled(SourmashError):
    pass


class CannotDownsampleNum(SourmashError):
    pass


class NeedsAbundanceTracking(SourmashError):
    pass
