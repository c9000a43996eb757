"""The benchmark's plain reference renderer."""
