"""The detection training CLI and its box-aware transforms."""
