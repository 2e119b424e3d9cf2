"""An Intrusion (NSL-KDD) table at the public schema's widths.

The 42 columns of the reference's ``Intrusion_train.csv`` in its order:
22 continuous and 20 categorical, as the ``INTRUSION`` preset reads them.
``protocol_type``, ``service`` and ``flag`` have the public schema's 3, 70
and 11 values; every other categorical count (``CARDINALITY``) is an
assumption, listed in the configuration file.  Each categorical column
is skewed towards its first value (a geometric law plus a floor that
makes every value likely to occur in 40,000 rows); the byte counts and
durations are log-normal and rounded, the counts integer, the rates in
[0, 1] with two decimals, as the real columns are.
"""

from __future__ import annotations

import numpy as np

from benchmark.tables import categorical_draw

PROTOCOLS = ("tcp", "udp", "icmp")
SERVICES = (
    "http", "private", "domain_u", "smtp", "ftp_data", "eco_i", "other",
    "ecr_i", "telnet", "finger", "ftp", "auth", "Z39_50", "uucp", "courier",
    "bgp", "whois", "uucp_path", "iso_tsap", "time", "imap4", "nnsp",
    "vmnet", "urp_i", "domain", "ctf", "csnet_ns", "supdup", "discard",
    "http_443", "daytime", "gopher", "efs", "systat", "link", "exec",
    "hostnames", "name", "mtp", "echo", "klogin", "login", "ldap",
    "netbios_dgm", "sunrpc", "netbios_ssn", "netstat", "netbios_ns",
    "kshell", "ssh", "nntp", "pop_3", "sql_net", "IRC", "ntp_u", "rje",
    "remote_job", "pop_2", "X11", "printer", "shell", "urh_i", "tim_i",
    "red_i", "pm_dump", "tftp_u", "http_8001", "aol", "http_2784",
    "harvest",
)
FLAGS = ("SF", "S0", "REJ", "RSTR", "RSTO", "SH", "S1", "S2", "RSTOS0",
         "S3", "OTH")
CLASSES = ("normal", "anomaly")

# distinct values of the categorical columns the public schema leaves
# numeric (assumed, after KDDTrain+'s counts)
CARDINALITY = {
    "land": 2, "wrong_fragment": 3, "urgent": 4, "hot": 28,
    "num_failed_logins": 6, "logged_in": 2, "num_compromised": 88,
    "root_shell": 2, "su_attempted": 3, "num_root": 82,
    "num_file_creations": 35, "num_shells": 3, "num_access_files": 10,
    "num_outbound_cmds": 1, "is_host_login": 2, "is_guest_login": 2,
}

COLUMNS = (
    "duration", "protocol_type", "service", "flag", "src_bytes",
    "dst_bytes", "land", "wrong_fragment", "urgent", "hot",
    "num_failed_logins", "logged_in", "num_compromised", "root_shell",
    "su_attempted", "num_root", "num_file_creations", "num_shells",
    "num_access_files", "num_outbound_cmds", "is_host_login",
    "is_guest_login", "count", "srv_count", "serror_rate",
    "srv_serror_rate", "rerror_rate", "srv_rerror_rate", "same_srv_rate",
    "diff_srv_rate", "srv_diff_host_rate", "dst_host_count",
    "dst_host_srv_count", "dst_host_same_srv_rate",
    "dst_host_diff_srv_rate", "dst_host_same_src_port_rate",
    "dst_host_srv_diff_host_rate", "dst_host_serror_rate",
    "dst_host_srv_serror_rate", "dst_host_rerror_rate",
    "dst_host_srv_rerror_rate", "class",
)
VOCAB = {"protocol_type": PROTOCOLS, "service": SERVICES, "flag": FLAGS,
         "class": CLASSES,
         **{name: tuple(str(v) for v in range(k))
            for name, k in CARDINALITY.items()}}


def _skewed(k: int) -> np.ndarray:
    """Weights of ``k`` values: geometric (ratio 0.6) plus a floor."""
    return 0.6 ** np.arange(k) + 1e-3


def generate(rows: int, seed: int) -> dict:
    rng = np.random.default_rng([seed, 0x1D5])
    out = {}
    for name in COLUMNS:
        if name in VOCAB:
            values = VOCAB[name]
            weights = ((0.53, 0.47) if name == "class"
                       else _skewed(len(values)))
            out[name] = categorical_draw(rng, values, weights, rows)
        elif name in ("duration", "src_bytes", "dst_bytes"):
            busy = rng.random(rows) < (0.1 if name == "duration" else 0.7)
            out[name] = np.where(busy, np.round(np.exp(
                rng.normal(5.0, 2.0, rows))), 0.0)
        elif name.endswith("_rate"):
            out[name] = np.round(rng.beta(0.4, 0.6, rows), 2)
        elif name.startswith("dst_host"):
            out[name] = np.round(rng.uniform(0.0, 255.0, rows))
        else:  # count, srv_count: connections in the last two seconds
            out[name] = np.round(rng.gamma(0.8, 100.0, rows)).clip(0, 511)
    return out


CATEGORICAL = ("protocol_type", "service", "flag", "land", "wrong_fragment",
               "urgent", "hot", "num_failed_logins", "logged_in",
               "num_compromised", "root_shell", "su_attempted", "num_root",
               "num_file_creations", "num_shells", "num_access_files",
               "num_outbound_cmds", "is_host_login", "is_guest_login",
               "class")
NON_NEGATIVE = ("dst_bytes", "src_bytes")
