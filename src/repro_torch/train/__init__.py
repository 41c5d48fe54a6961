"""Training: AdamW (``optimizer``) and the train step and loop
(``train_loop``)."""
