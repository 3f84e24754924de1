"""Host-side helpers of the port (request carriers; checkpoint storage and formats)."""
