"""Shape and schedule helpers (pure Python)."""
