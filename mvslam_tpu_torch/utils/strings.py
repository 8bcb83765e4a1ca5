"""String utilities + typed string conversion (copy of
``mvslam_tpu.utils.strings``).

Parity with the reference's ``source/base/string-manipulation.{hpp,cpp}``
(trim/case/classification helpers) and ``source/base/conversion.hpp:48-118``
(string -> int/scalar/bool traits used by the parameter system). The
conversion entry point used by configs lives in
:func:`mvslam_tpu_torch.config._convert`; these are the standalone predicates.
"""

from __future__ import annotations


def string_trim_whitespaces(s: str) -> str:
    """Strip leading/trailing whitespace (reference
    ``string-manipulation.cpp:19-37``)."""
    return s.strip()


def string_to_upper(s: str) -> str:
    return s.upper()


def string_to_lower(s: str) -> str:
    return s.lower()


def string_is_alphabet(s: str) -> bool:
    """True iff non-empty and all characters are letters."""
    return len(s) > 0 and s.isalpha()


def string_is_scalar(s: str) -> bool:
    """True iff the string parses as a (possibly signed, possibly
    scientific-notation) real number (reference
    ``string-manipulation.cpp:68-112``)."""
    s = s.strip()
    if not s:
        return False
    try:
        float(s)
    except ValueError:
        return False
    # the reference rejects inf/nan spellings: only digit-built scalars
    return any(c.isdigit() for c in s)


def string_is_boolean(s: str) -> bool:
    """True iff 'TRUE'/'FALSE' (any case) or a scalar (the reference's
    positive-scalar bool semantics, ``conversion.hpp:48-74``)."""
    t = s.strip().upper()
    return t in ("TRUE", "FALSE") or string_is_scalar(s)


def convert_to_bool(s: str) -> bool:
    """'TRUE'/'true' or any positive scalar -> True; 'FALSE'/'false' or any
    non-positive scalar -> False (reference ``conversion.hpp:48-74``)."""
    t = s.strip().upper()
    if t == "TRUE":
        return True
    if t == "FALSE":
        return False
    try:
        return float(s) > 0.0
    except ValueError as e:
        raise ValueError(f"cannot convert {s!r} to bool") from e
