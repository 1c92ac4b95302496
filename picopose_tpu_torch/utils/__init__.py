"""Host-side helpers: weight conversion and seeded random weights."""
