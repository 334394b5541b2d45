"""Response schemas (``api/app/schemas.py``) as dataclasses: the card's machine has no
pydantic. The same fields, the check that confidence lies in [0, 1], and
``model_dump()``."""

from dataclasses import asdict, dataclass
from typing import Dict

__all__ = ["ClsCandidate", "Status"]


@dataclass
class ClsCandidate:
    """Classification result."""

    value: str
    confidence: float

    def __post_init__(self) -> None:
        if not isinstance(self.value, str):
            raise TypeError(f"value must be a string, got {type(self.value).__name__}")
        self.confidence = float(self.confidence)
        if not 0 <= self.confidence <= 1:
            raise ValueError(f"confidence must lie in [0, 1], got {self.confidence}")

    def model_dump(self) -> Dict:
        return asdict(self)


@dataclass
class Status:
    """Healthcheck payload."""

    status: str
    project: str
    version: str

    def model_dump(self) -> Dict:
        return asdict(self)
