"""Host-side data pipeline (numpy only)."""
