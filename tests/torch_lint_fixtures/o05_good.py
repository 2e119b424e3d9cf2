"""obslint O05 good twin: every fault-spec kind parses."""

PLAN = "kill_client:rank=1,round=2"
NOTE = "inject delay_msg:ms=50 then sever_conn:rank=1,after=2"
