"""Training of one cascade stage: `Trainer` and its optimizer arithmetic."""

from .trainer import StageState, Trainer

__all__ = ["StageState", "Trainer"]
