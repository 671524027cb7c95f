"""Single-device training of KTWE-LM: the train step, its optimizer and
step telemetry."""
