"""The port's dry run on an H100 cost model: the card's datasheet peaks
(`hardware`), the cost of a step traced on fake tensors (`graph`), and
the per-op breakdown and tables of the dry run's results (`breakdown`,
`report`)."""
