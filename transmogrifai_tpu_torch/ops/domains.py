"""Email/URL domain extraction transformers.

Reference: core/.../stages/impl/feature/EmailToPickListMapTransformer.scala
(Email → PickList of its domain) and UrlMapToPickListMapTransformer.scala
(URLMap → PickListMap of valid URLs' domains).
"""
from __future__ import annotations

import re
from urllib.parse import urlparse

import numpy as np

from ..stages.base import Transformer
from ..types import Email, OPMap, PickList, PickListMap
from ..types.columns import Column, MapColumn, TextColumn

_URL_SCHEME_RE = re.compile(r"^(https?|ftp)://", re.IGNORECASE)


def email_domain(v: str | None) -> str | None:
    """Email.domain: the part after a single '@' (Email.scala)."""
    if not v or v.count("@") != 1:
        return None
    prefix, domain = v.split("@")
    return domain if prefix and domain else None


def url_domain(v: str | None) -> str | None:
    """URL.domain for valid http/https/ftp URLs (URL.scala)."""
    if not v or not _URL_SCHEME_RE.match(v):
        return None
    try:
        host = urlparse(v).hostname
    except ValueError:
        return None
    return host or None


class EmailToPickListTransformer(Transformer):
    """Email → PickList of the email's domain
    (EmailToPickListMapTransformer.scala:50)."""

    input_types = (Email,)
    output_type = PickList

    def __init__(self, uid: str | None = None):
        super().__init__("emailToPickList", uid=uid)

    def transform_columns(self, *cols: Column, num_rows: int) -> TextColumn:
        col = cols[0]
        assert isinstance(col, TextColumn)
        out = np.empty(num_rows, dtype=object)
        out[:] = [email_domain(v) for v in col.values]
        return TextColumn(PickList, out)


class UrlMapToPickListMapTransformer(Transformer):
    """URLMap → PickListMap of valid URLs' domains
    (UrlMapToPickListMapTransformer.scala:37)."""

    input_types = (OPMap,)
    output_type = PickListMap

    def __init__(self, uid: str | None = None):
        super().__init__("urlMapToPickListMap", uid=uid)

    def transform_columns(self, *cols: Column, num_rows: int) -> MapColumn:
        col = cols[0]
        assert isinstance(col, MapColumn)
        out = []
        for m in col.values:
            kept = {}
            for k, v in (m or {}).items():
                d = url_domain(v)
                if d is not None:
                    kept[k] = d
            out.append(kept)
        return MapColumn(PickListMap, out)
