from .pipeline import SyntheticLM

__all__ = ["SyntheticLM"]
