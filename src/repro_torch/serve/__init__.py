"""Serving front ends of the port: the CSNN engine (``csnn_engine``) and
the LM engine (``engine``)."""
