"""Text cleaning with the reference's TextUtils semantics (the one helper
serving's one-hot pivots need)."""
from __future__ import annotations

import re

_PUNCT_RE = re.compile(r"[\W_]+", flags=re.UNICODE)


def clean_string(raw: str) -> str:
    """TextUtils.cleanString: lowercase, strip punctuation, capitalize each
    word, join with no separator ("hello-world!" -> "HelloWorld")."""
    words = _PUNCT_RE.sub(" ", raw.lower()).split()
    return "".join(w.capitalize() for w in words)
