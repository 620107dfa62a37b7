"""Linearizability checking: host encoding, the device search, the host
WGL oracle and the ``Linearizable`` checker."""
