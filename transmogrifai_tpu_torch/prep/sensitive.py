"""Sensitive-feature detection — flags columns that look like personal data:
the port's copy of the JAX package's ``prep/sensitive.py`` (host code, the
same detectors, thresholds and records).

Reference: utils/.../op/SensitiveFeatureInformation.scala:1-164 (records
detected-name and other sensitive columns in stage metadata; populated by
the name-detection pass inside SmartTextVectorizer when sensitive-feature
mode is on). Equivalent here: a dataset-level scan producing
``SensitiveFeatureInformation`` records that the workflow stores in the
model summary, so downstream governance can see which raw features carried
names / emails / phones / urls and act (e.g. DetectAndRemove).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Sequence

from ..dataset import Dataset
from ..features.feature import Feature
from ..ops.text_stages import _COMMON_NAMES, _EMAIL_RE
from ..types import Email, Phone, Text, URL
from ..nlp.name_model import is_probable_name
from ..types.columns import TextColumn
from ..utils.text import tokenize

def is_subtype(t: type, parent: type) -> bool:
    """True if feature type ``t`` is ``parent`` or a subtype of it."""
    return isinstance(t, type) and issubclass(t, parent)


# phone shapes: 7-15 digits with optional +/()/separators; date-like strings
# (ISO or slashed) and short plain-digit ids must NOT match
_PHONE_RE = re.compile(r"^\+?[\d\s().-]{7,17}$")
_DATE_LIKE_RE = re.compile(
    r"^\d{4}[-/.]\d{1,2}[-/.]\d{1,2}$|^\d{1,2}[-/.]\d{1,2}[-/.]\d{2,4}$"
)


def _looks_like_phone(v: str) -> bool:
    if not _PHONE_RE.match(v) or _DATE_LIKE_RE.match(v):
        return False
    digits = sum(c.isdigit() for c in v)
    if not 7 <= digits <= 15:
        return False
    # plain digit runs under 10 digits are more likely ids than phones
    if v.isdigit() and digits < 10:
        return False
    return True
_URL_RE = re.compile(r"^(https?|ftp)://", re.IGNORECASE)


@dataclasses.dataclass
class SensitiveFeatureInformation:
    """One flagged feature (SensitiveFeatureInformation.scala)."""

    name: str
    kind: str                 # Name | Email | Phone | Url
    proportion_matched: float
    action_taken: bool = False

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "kind": self.kind,
            "proportionMatched": round(self.proportion_matched, 4),
            "actionTaken": self.action_taken,
        }


def detect_sensitive_features(
    dataset: Dataset,
    features: Sequence[Feature],
    threshold: float = 0.5,
    names: frozenset = _COMMON_NAMES,
    use_model: bool = True,
) -> list[SensitiveFeatureInformation]:
    """Scan text-family columns for person names / emails / phones / urls.
    Declared types (Email/Phone/URL features) are flagged outright; plain
    Text columns are sampled against the detectors. ``use_model`` adds the
    trained char-level name model (nlp/name_model.py) on top of the
    dictionary; pass False for dictionary-only precision."""
    name_set = frozenset(n.lower() for n in names)
    out: list[SensitiveFeatureInformation] = []
    for f in features:
        if f.name not in dataset:
            continue
        col = dataset[f.name]
        if not isinstance(col, TextColumn):
            continue
        if is_subtype(f.ftype, Email):
            out.append(SensitiveFeatureInformation(f.name, "Email", 1.0))
            continue
        if is_subtype(f.ftype, Phone):
            out.append(SensitiveFeatureInformation(f.name, "Phone", 1.0))
            continue
        if is_subtype(f.ftype, URL):
            out.append(SensitiveFeatureInformation(f.name, "Url", 1.0))
            continue
        if not is_subtype(f.ftype, Text):
            continue
        values = [v for v in col.values if v]
        if not values:
            continue
        counts = {"Name": 0, "Email": 0, "Phone": 0, "Url": 0}
        for v in values:
            if _EMAIL_RE.match(v):
                counts["Email"] += 1
            elif _URL_RE.match(v):
                counts["Url"] += 1
            elif _looks_like_phone(v):
                counts["Phone"] += 1
            else:
                toks = tokenize(v)
                if toks and any(
                    t in name_set
                    or (use_model and is_probable_name(t, threshold=0.7))
                    for t in toks
                ):
                    counts["Name"] += 1
        n = len(values)
        # report the DOMINANT kind crossing the threshold, not the first in
        # dict order — a 60%-email / 30%-name column is an Email column
        kind, c = max(counts.items(), key=lambda kv: kv[1])
        if c / n >= threshold:
            out.append(SensitiveFeatureInformation(f.name, kind, c / n))
    return out
