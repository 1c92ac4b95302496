"""Host-side detection decoding and crops (numpy only)."""
