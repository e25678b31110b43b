"""Plan generation, the frontier engine and the driver."""
