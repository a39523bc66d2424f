"""Host-side helpers of the port (image quality metrics)."""
