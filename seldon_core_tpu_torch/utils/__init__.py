"""Host-side helpers of the port (request carriers)."""
