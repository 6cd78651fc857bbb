"""cephlint's runtime half for the port.

Only `racecheck` (the asyncio lock-order and task-leak detector that the
messenger and the stack report into) is ported. The static checks of the
reference package's `lint` (`core`, `checks`, the CLI) are not, so this
package exports nothing of its own yet.
"""
