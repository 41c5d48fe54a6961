"""The runtime half of the page-ledger checks (``PL25x``); the static
passes of ``repro/analysis/lint`` lint the port's sources as they are."""
