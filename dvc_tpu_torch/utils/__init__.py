"""Framework-neutral helpers: wav IO, device rules, the weight bridge."""
