"""Host-side utilities of the port: ids, resources, config, status, the
fault-point hook and GPU detection."""
