"""The port's service layer: the submission front door
(`service/admission.py`)."""
