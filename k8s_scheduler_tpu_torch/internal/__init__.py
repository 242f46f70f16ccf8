"""Host-side scheduler state: the cache and the scheduling queue."""
