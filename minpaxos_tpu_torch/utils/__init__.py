"""Host helpers of the serving path: ports, clocks, debug logging."""
