"""The benchmark's own library: cell lookup, guards, statistics, peaks,
trace reading, seeded weights and the traffic generators."""
