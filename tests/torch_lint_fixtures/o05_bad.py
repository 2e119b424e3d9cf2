"""obslint O05 bad twin: fault-spec strings faults.py cannot parse.

Never imported -- parsed by the analyzer only.  The JAX package's
repo-wide gate scans every test file for fault specs too, so each bad
spec carries that package's escape on the line above (the port's escape
is another word, so the port's rules still flag the specs).
"""

# jaxlint: disable=O05
PLAN = "kill_clientt:rank=1,round=2"  # EXPECT: O05
# jaxlint: disable=O05
NOTE = "inject delay_msg:ms=50 then sever_con:rank=1,after=2"  # EXPECT: O05
