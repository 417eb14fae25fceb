"""Decoupled serving: table store, BSE server, CTR server, quantized storage."""
