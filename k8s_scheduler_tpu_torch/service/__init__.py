"""The port's service layer: the submission front door
(`service/admission.py`) and the gRPC shim (`server.py`, `client.py`,
`convert.py`, `scheduler_pb2.py`). The shim's modules import grpc, so
this package imports none of them: import them by name."""
